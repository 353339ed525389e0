"""The kernels' host side, on the CPU: the split-K plan of the paged
attention kernel, the bound C functions of the paged and RMSNorm
wrappers, and the build's source hash.

No kernel runs here.  The launch tests hand the wrappers a stand-in
library (Python functions in place of the C ones) and CPU tensors, so
what they check is the host path itself: the guards, the plan and the
arguments passed, and that the library is loaded and typed once.
"""
import types

import pytest
import torch

from distributed_tensorflow_tpu_torch.ops.kernels import _build
from distributed_tensorflow_tpu_torch.ops.kernels import fused
from distributed_tensorflow_tpu_torch.ops.kernels import paged_attention as pa

torch.set_num_threads(1)


@pytest.mark.parametrize("blocks,n_cols,sms,tc", [
    (64, 8192, 132, False),       # Llama-3-8B decode, 8 slots
    (96, 1024, 132, False),       # GPT-2 decode, 8 slots
    (12, 532, 132, True),         # GPT-2 window at pos 500
    (8, 332, 132, True),          # Llama window at pos 300
    (1, 1, 132, False), (1, 31, 132, True), (1, 33, 132, True),
    (4096, 8192, 132, False), (3, 100000, 16, False), (1, 64, 1, True)])
def test_split_plan_bounds(blocks, n_cols, sms, tc):
    """At least one split, no more than the row's sub-tiles of 32, every
    split non-empty and together covering them, at most 16; the same
    answer for the same shapes."""
    splits, per = pa.split_plan(blocks, n_cols, sms, tc)
    n_sub = -(-n_cols // 32)
    assert 1 <= splits <= min(n_sub, 16)
    assert (splits - 1) * per < n_sub <= splits * per
    assert pa.split_plan(blocks, n_cols, sms, tc) == (splits, per)


def test_split_plan_fills_the_card_at_the_llama_decode_shape():
    """64 (row, kv head) pairs on 132 SMs: enough splits for about four
    blocks an SM; a lone long row gets the most splits allowed."""
    splits, per = pa.split_plan(64, 8192, 132, False)
    assert splits * 64 >= 2 * 132 and per * 32 * splits >= 8192
    assert pa.split_plan(1, 8192, 132, False)[0] == 16


def _fake_paged_lib(calls):
    def forward(*args):
        calls.append(args)
        return 0

    def smem(is_bf16, kv_int8, hd, tc, window, group, per):
        return 0 if hd not in (64, 128) else 1000 + per
    return types.SimpleNamespace(paged_attention_forward=forward,
                                 paged_attention_smem_bytes=smem)


@pytest.fixture
def fake_paged(monkeypatch):
    """The paged wrapper over a stand-in library, a 132-SM card and a
    workspace on the CPU; yields (forward calls, library loads)."""
    calls, loads = [], []

    def load(name):
        loads.append(name)
        return _fake_paged_lib(calls)
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_bound", {})
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(pa, "_smem", {})
    monkeypatch.setattr(pa, "_sm_counts", {-1: 132})
    monkeypatch.setattr(pa, "_scratch", {(-1, 0): (
        torch.empty(1 << 20), torch.zeros(4096, dtype=torch.int32), [])})
    return calls, loads


def _decode_inputs(dtype=torch.bfloat16, int8=False, S=8, h=32, kvh=8,
                   hd=128, pg=16, P=512):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(S, 1, h, hd, generator=gen).to(dtype)
    shape = (2, 9, pg, kvh, hd)
    kv = {"k": torch.zeros(shape, dtype=torch.int8 if int8 else dtype),
          "v": torch.zeros(shape, dtype=torch.int8 if int8 else dtype)}
    if int8:
        kv["k_scale"] = torch.zeros(*shape[:4], 1)
        kv["v_scale"] = torch.zeros(*shape[:4], 1)
    tab = torch.zeros(S, P, dtype=torch.int32)
    valid = torch.zeros(S, P * pg, dtype=torch.bool)
    return q, kv, tab, valid


# the C entry's arguments, by position (csrc/paged_attention.cu)
_ARG = {name: i for i, name in enumerate(
    "q k v k_scale v_scale page_tab valid out ws tickets is_bf16 kv_int8 "
    "window tc B sq h kvh hd num_pages page_size pages_per_row layer pos "
    "n_cols splits per scale stream".split())}


def test_paged_wrapper_binds_once_and_passes_the_plan(fake_paged):
    calls, loads = fake_paged
    q, kv, tab, valid = _decode_inputs(int8=True)
    before = pa.LAUNCHES["paged_decode_int8"]
    n_loads = []
    for layer in (0, 1):
        out = pa._launch(q, kv, layer, tab, valid, 0, window=False,
                         scale=None)
        assert out.shape == q.shape and out.dtype == q.dtype
        n_loads.append(len(loads))
    # the launch and the shared-memory functions, each typed once
    assert set(loads) == {"paged_attention"} and n_loads == [2, 2]
    assert len(calls) == 2 and pa.LAUNCHES["paged_decode_int8"] == before + 2
    args = calls[0]
    want = pa.split_plan(8 * 8, 8192, 132, False)
    assert (args[_ARG["splits"]], args[_ARG["per"]]) == want
    assert args[_ARG["n_cols"]] == 8192 and not args[_ARG["tc"]]
    assert args[_ARG["kv_int8"]] and args[_ARG["is_bf16"]]
    assert args[_ARG["scale"]] == pytest.approx(128 ** -0.5)
    assert [c[_ARG["layer"]] for c in calls] == [0, 1]


def test_paged_wrapper_window_plan_and_route(fake_paged):
    """A bf16 window runs on the tensor cores over the columns up to
    pos + sq; f32 q on the CUDA cores; forced splits are honoured."""
    calls, _ = fake_paged
    gen = torch.Generator().manual_seed(1)
    kv = {k: torch.zeros(2, 9, 16, 12, 64, dtype=torch.bfloat16)
          for k in ("k", "v")}
    qw = torch.randn(1, 32, 12, 64, generator=gen).to(torch.bfloat16)
    row = torch.zeros(1, 64, dtype=torch.int32)
    pa._launch(qw, kv, 0, row, None, 500, window=True, scale=None)
    args = calls[-1]
    assert args[_ARG["tc"]] and args[_ARG["window"]]
    assert args[_ARG["n_cols"]] == 532
    assert (args[_ARG["splits"]], args[_ARG["per"]]) == pa.split_plan(
        12, 532, 132, True)
    kv32 = {k: v.float() for k, v in kv.items()}
    pa._launch(qw.float(), kv32, 0, row, None, 1000, window=True, scale=0.5,
               splits=1)
    args = calls[-1]
    assert not args[_ARG["tc"]] and args[_ARG["n_cols"]] == 1024
    assert args[_ARG["splits"]] == 1 and args[_ARG["per"]] == 32
    assert args[_ARG["scale"]] == 0.5


@pytest.mark.parametrize("is_bf16,int8,window,want", [
    (True, False, True, True), (True, True, True, True),
    (True, False, False, True), (True, True, False, False),
    (False, False, True, False), (False, True, False, False)],
    ids=["bf16-window", "int8-window", "bf16-decode", "int8-decode",
         "f32-window", "f32-int8-decode"])
def test_paged_route_is_decided_by_the_dtypes(fake_paged, is_bf16, int8,
                                              window, want):
    """The tensor cores for every bf16 window and for bf16 decode over a
    bf16 pool, the CUDA cores otherwise; the launch passes that route and
    sizes the workspace for its block's query count."""
    calls, _ = fake_paged
    assert pa.tensor_cores(is_bf16, int8, window) is want
    dtype = torch.bfloat16 if is_bf16 else torch.float32
    q, kv, tab, valid = _decode_inputs(dtype=dtype, int8=int8, S=1, P=16)
    if window:
        q = q.expand(1, 16, *q.shape[2:]).contiguous()
        pa._launch(q, kv, 0, tab, None, 100, window=True, scale=None)
    else:
        pa._launch(q, kv, 0, tab, valid, 0, window=False, scale=None)
    assert bool(calls[-1][_ARG["tc"]]) is want


def test_paged_workspace_is_per_stream_and_never_freed(monkeypatch):
    """Each (device, stream) has its own workspace and tickets; a launch
    that needs more grows them at least twofold and keeps the old pair
    alive (a CUDA graph captured earlier still uses it); a smaller need
    reuses what is there."""
    monkeypatch.setattr(pa, "_scratch", {})
    ws, tickets = pa._workspace("cpu", 1, 100, 4)
    assert ws.numel() == 100 and tickets.numel() == 4
    assert not tickets.any()
    assert pa._workspace("cpu", 1, 50, 2)[0] is ws
    other, _ = pa._workspace("cpu", 2, 50, 2)
    assert other is not ws
    grown, grown_t = pa._workspace("cpu", 1, 120, 4)
    assert grown.numel() == 200 and grown_t.numel() == 8
    assert pa._scratch[("cpu", 1)][2] == [(ws, tickets)]
    assert pa._workspace("cpu", 1, 10, 1)[0] is grown


def test_paged_forced_splits_cover_the_columns():
    """A forced split count is capped at 16 and at the row's sub-tiles;
    the shares still cover every column."""
    for splits, n_cols in ((1, 8192), (3, 200), (40, 8192), (8, 64)):
        blocks, got, per = pa.launch_plan(8, 1, 32, 8, n_cols, False, -1,
                                          splits)
        n_sub = -(-n_cols // 32)
        assert blocks == 64 and got <= min(splits, 16, n_sub)
        assert (got - 1) * per < n_sub <= got * per


def test_paged_wrapper_refuses_before_any_launch(fake_paged):
    calls, _ = fake_paged
    q, kv, tab, valid = _decode_inputs(int8=True)
    with pytest.raises(ValueError, match="both"):
        pa._launch(q, {k: v for k, v in kv.items() if k != "v_scale"}, 0,
                   tab, valid, 0, window=False, scale=None)
    with pytest.raises(TypeError, match="page_tab"):
        pa._launch(q, kv, 0, tab.long(), valid, 0, window=False, scale=None)
    with pytest.raises(ValueError, match="layer"):
        pa._launch(q, kv, 2, tab, valid, 0, window=False, scale=None)
    q96, kv96, tab96, valid96 = _decode_inputs(hd=96)
    with pytest.raises(ValueError, match="head_dim"):
        pa._launch(q96, kv96, 0, tab96, valid96, 0, window=False, scale=None)
    assert calls == []


def test_rmsnorm_wrapper_binds_once(monkeypatch):
    """The C function is loaded and typed once; it gets the shapes and
    the card's SM count, which the wrapper reads once per device (here
    the CPU tensors' device index, -1), not once per call."""
    calls, loads, props = [], [], []

    def forward(*args):
        calls.append(args)
        return 0

    def load(name):
        loads.append(name)
        return types.SimpleNamespace(rmsnorm_forward=forward)

    def properties(dev):
        props.append(dev)
        return types.SimpleNamespace(multi_processor_count=132 + dev)
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_bound", {})
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(fused, "_SMS", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", properties)
    x = torch.randn(8, 4096).to(torch.bfloat16)
    gamma = torch.ones(4096)
    before = fused.LAUNCHES["rmsnorm"]
    for _ in range(3):
        out = fused._rmsnorm_launch(x, gamma, 1e-5)
        assert out.shape == x.shape and out.dtype == x.dtype
    assert loads == ["rmsnorm"] and len(calls) == 3 and props == [-1]
    assert fused.LAUNCHES["rmsnorm"] == before + 3
    xp, gp, op, is_bf16, rows, d, eps, sms, _ = calls[0]
    assert (xp, gp) == (x.data_ptr(), gamma.data_ptr()) and op != xp
    assert (is_bf16, rows, d, sms) == (True, 8, 4096, 131)
    assert eps == pytest.approx(1e-5)
    assert fused._SMS == {-1: 131}
    # another device is read once too
    assert [fused._SMS.get(1) or fused._sm_count(1) for _ in range(2)] \
        == [133, 133]
    assert props == [-1, 1]
    with pytest.raises(ValueError, match="gamma"):
        fused._rmsnorm_launch(x, gamma.double(), 1e-5)
    assert len(calls) == 3


def test_rmsnorm_wrapper_passes_rows_of_any_leading_shape(monkeypatch):
    """x [..., d] is rows = numel / d rows of d, in f32 as in bf16; an
    empty x launches nothing."""
    calls = []
    monkeypatch.setattr(_build, "_bound", {("rmsnorm", "rmsnorm_forward"):
                                           lambda *a: calls.append(a) or 0})
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(fused, "_SMS", {-1: 132})
    gamma = torch.ones(128)
    fused._rmsnorm_launch(torch.randn(5, 7, 128), gamma, 1e-6)
    assert [(c[3], c[4], c[5]) for c in calls] == [(False, 35, 128)]
    out = fused._rmsnorm_launch(torch.randn(0, 128), gamma, 1e-6)
    assert out.shape == (0, 128) and len(calls) == 1


@pytest.mark.parametrize("grad_enabled,requires_grad,want", [
    (True, (False, False), False), (True, (True, False), True),
    (True, (False, True), True), (False, (True, True), False)],
    ids=["no-input-needs-grad", "x-needs-grad", "gamma-needs-grad",
         "under-no-grad"])
def test_rmsnorm_direct_launch_only_when_autograd_would_not_record(
        grad_enabled, requires_grad, want):
    """``fused_rmsnorm`` launches a CUDA call directly when this is False
    and through ``_RMSNorm.apply`` when it is True."""
    tensors = [torch.ones(4, 8).requires_grad_(r) for r in requires_grad]
    with torch.set_grad_enabled(grad_enabled):
        assert fused._needs_grad(*tensors) is want


def test_build_target_hashes_included_headers(tmp_path, monkeypatch):
    """An edit to a header a source includes, directly or through another
    header, names a new library; an edit elsewhere does not."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert [p.name for p in _build._sources(tmp_path / "k.cu")] == [
        "k.cu", "a.cuh", "b.cuh"]
    (tmp_path / "other.cuh").write_text("// other, edited\n")
    assert _build._target("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build._target("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// edited\n')
    assert _build._target("k") not in (first, second)


@pytest.mark.parametrize("name", ["paged_attention", "flash_attention"])
def test_kernel_sources_share_the_helper_header(name):
    """Both attention sources include ``hopper.cuh``, so its hash is in
    both libraries' names."""
    names = [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")]
    assert names == [f"{name}.cu", "hopper.cuh"]


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_dq_mma_\
kernelILi64EEEvPK13__nv_bfloat16S3_S3_PKhS3_S3_PKfPfPS1_iiiiffi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_dq_mma_\
kernelILi64EEEvPK13__nv_bfloat16S3_S3_PKhS3_S3_PKfPfPS1_iiiiffi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__af6443_18_flash_\
attention_cu_115e27c516flash_dkv_kernelILi128EEEvPKfS2_S2_PKhS2_S2_S2_PfS4_iiii\
fi' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__af6443_18_flash_\
attention_cu_115e27c516flash_dkv_kernelILi128EEEvPKfS2_S2_PKhS2_S2_S2_PfS4_iiii\
fi
    24 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 440 bytes cmem[0]
ptxas info    : Compiling entry function 'rmsnorm_plain_c' for 'sm_90a'
ptxas info    : Used 12 registers
"""


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_118rmsnorm_vec_kernelI13__nv_bfloat16Li4EEEvPKT_PKf"
     "PS2_iif", "rmsnorm_vec_kernel<__nv_bfloat16,4>"),
    ("_ZN12_GLOBAL__N_118rmsnorm_vec_kernelIfLi4EEEvPKT_PKfPS1_iif",
     "rmsnorm_vec_kernel<float,4>"),
    ("_ZN12_GLOBAL__N_119rmsnorm_loop_kernelIfEEvPKT_PKfPS1_ifi",
     "rmsnorm_loop_kernel<float>"),
    ("_ZN12_GLOBAL__N_115paged_cc_kernelI13__nv_bfloat16aLi128ELb1ELi4EEEv"
     "PKT_", "paged_cc_kernel<__nv_bfloat16,signed char,128,1,4>"),
    ("_ZN12_GLOBAL__N_18x_kernelILin3EEEvv", "x_kernel<-3>"),
    ("_ZN12_GLOBAL__N_18x_kernelIPfEEvv", "x_kernel"),
    ("_ZN12_GLOBAL__N_18x_kernelEv", "x_kernel"),
    ("rmsnorm_plain_c", "rmsnorm_plain_c")],
    ids=["bf16", "f32", "loop", "paged", "negative", "pointer-arg",
         "no-template", "not-a-kernel"])
def test_kernel_name_keeps_every_template_argument(mangled, name):
    """Instantiations that differ in any template argument (a type, an
    integer, a bool) get names of their own; arguments of another form
    leave the bare kernel name."""
    assert _build._kernel_name(mangled) == name


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    """The compiler's ``-Xptxas=-v`` output kept beside a library reads as
    registers, stack and spill bytes per kernel, named by the kernel and
    its template arguments (here the head dim), also inside an
    anonymous namespace whose mangled name ends in digits."""
    assert "-Xptxas=-v" in _build.NVCC_FLAGS
    lib = tmp_path / "flash_attention-0123.so"
    lib.with_suffix(".log").write_text(_PTXAS_LOG)
    monkeypatch.setattr(_build, "load", lambda name: None)
    monkeypatch.setattr(_build, "_target", lambda name: lib)
    assert _build.ptxas_report("flash_attention") == {
        "flash_dq_mma_kernel<64>": dict(registers=168, stack=0,
                                        spill_stores=0, spill_loads=0),
        "flash_dkv_kernel<128>": dict(registers=255, stack=24,
                                      spill_stores=8, spill_loads=12),
        "rmsnorm_plain_c": dict(registers=12)}
