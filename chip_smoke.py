#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--iters N] [--profile DIR]

Phases, in order; any failure ends the run with a non-zero exit code and
no result lines:

1. device: requires CUDA; prints the card's name, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build: compiles every CUDA source of the port (one nvcc each, all at
   once) and prints the seconds.
3. kernels: each kernel at its path's shapes against its plain PyTorch
   version on the card, with the tolerance: the serving kernels at the
   engine's shapes (GPT-2 small, bf16, 8 slots, pages of 16, max_len
   1024, prefill windows of 32), the training kernels at the training
   step's (flash attention b 48, s 256, 12 heads of 64, bf16, causal;
   Adam on the 38.6M-element word embedding and a [768, 3072] kernel),
   plus flash at s 1024 and an f32 GQA / kv-valid / ragged case.  Times
   the kernel, the plain version and one PyTorch library call computing
   the same function (CUDA events over many launches), and computes the
   least time the card could take from the bytes and flops these inputs
   need (3.35 TB/s, 989 TFLOP/s bf16: H100 SXM data sheet).
4. engine: GPT-2 small at full width (random weights from ``--seed``)
   behind ``Engine``: 12 requests (4 sharing a 256-token system prompt),
   drained; checks budgets, the prefix-cache hit rate, that every
   kernel's launch count rose during this run, and row independence (a
   request's tokens alone, in the batch and on a prefix hit are equal).
   Prints tokens/s and TTFT.
5. reference: a 2-layer f32 model on the card and the same weights on
   the CPU (plain versions) must emit the same greedy tokens.
6. training: GPT-2 small at full width, bf16 compute over f32 weights,
   ``adamw(1e-4)``, global-norm clip 1.0, dropout 0, batch 48 x 256
   tokens (rows of 257 ids from ``--seed``, the JAX package's bench
   row): 2 warm-up and 10 timed steps on one batch.  Checks finite
   losses, the last below the first, and that each training kernel
   launched exactly its per-step count times the steps.  Prints step ms,
   tokens/s, mfu (model flops / step time / 989 TFLOP/s) and peak memory.
7. training reference: a 2-layer f32 model trained 3 steps on the card
   (kernels) and from the same weights on the CPU (plain versions):
   per-step losses and final parameters must agree.
8. train-then-serve: the trained GPT-2-small weights serve 2 requests
   through ``Engine``; serving builds no autograd graph.
9. with ``--profile DIR`` only: the engine phase and 3 training steps
   again under ``torch.profiler``; the device's busy share and its top
   kernels.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_FLOPS_PER_S = 989e12        # H100 SXM, dense

DECODE_TOL = 2e-2     # bf16: the plain version rounds logits and weights
WINDOW_TOL = 2e-2
LN_TOL = 1e-2         # about one bf16 ulp at unit scale
F32_TOL = 1e-4        # f32: summation order only
# flash attention, relative to the output's scale (tol * max(1, max|want|)):
# in bf16 both sides compute in f32 from the same inputs and round once
# (one bf16 ulp is 2**-8 relative); in f32 summation order only
FLASH_BF16_TOL = 1e-2
FLASH_F32_TOL = 1e-4
ADAM_TOL = 1e-6       # f32, |values| <= a few: a contracted multiply-add
TRAIN_LOSS_TOL = 1e-4     # card vs CPU, f32 losses: summation order
# card vs CPU, f32 parameters after 3 Adam steps at lr 1e-4: an element
# whose gradient is ~0 may step by up to 2 lr differently per step
TRAIN_PARAM_TOL = 1e-3

TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 48, 256, 1e-4
TRAIN_WARMUP, TRAIN_STEPS = 2, 10


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_kernels(torch, args):
    """Phase 3: returns {kernel name: record} for the kernels line."""
    import torch.nn.functional as F

    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed)
    L, h, kvh, hd, pg, P, S = 12, 12, 12, 64, 16, 64, 8
    NP = S * P + 1                     # the engine's default pool
    view_len = P * pg
    records = {}

    def pool(dtype):
        shape = (L, NP, pg, kvh, hd)
        return {k: torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)
                for k in ("k", "v")}

    # --- paged decode: ragged rows, two rows wholly on the trash page
    perm = torch.randperm(NP - 1, generator=gen, device=dev) + 1
    tab = perm[:S * P].reshape(S, P).to(torch.int32)
    tab[3] = 0
    tab[6] = 0
    lengths = torch.tensor([37, 300, 1000, 5, 513, 64, 129, 777],
                           device=dev)
    starts = torch.tensor([0, 0, 16, 0, 100, 0, 0, 3], device=dev)
    cols = torch.arange(view_len, device=dev)[None, :]
    valid = ((cols >= starts[:, None]) & (cols < lengths[:, None]))
    valid = valid.contiguous()
    kv = pool(torch.bfloat16)
    q = torch.randn(S, 1, h, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    err = 0.0
    for layer in (0, 5, 11):
        got = pa.paged_decode_attention(q, kv, layer, tab, valid)
        want = pa.paged_decode_attention_plain(q, kv, layer, tab, valid)
        err = max(err, (got.float() - want.float()).abs().max().item())
    log({"check": "paged_decode_attention", "dtype": "bf16",
         "max_abs_err": err, "tol": DECODE_TOL})
    if not err <= DECODE_TOL:
        raise AssertionError(f"paged decode kernel disagrees: {err}")
    kv32 = {k: v.float() for k, v in kv.items()}
    q32 = q.float()
    got = pa.paged_decode_attention(q32, kv32, 7, tab, valid)
    want = pa.paged_decode_attention_plain(q32, kv32, 7, tab, valid)
    err32 = (got - want).abs().max().item()
    log({"check": "paged_decode_attention", "dtype": "f32",
         "max_abs_err": err32, "tol": F32_TOL})
    if not err32 <= F32_TOL:
        raise AssertionError(f"paged decode kernel (f32) disagrees: {err32}")
    del kv32, q32

    layers = iter(range(10 ** 9))

    def nxt():
        return next(layers) % L

    def sdpa_decode():
        k, v = pa.paged_layer_kv(kv, nxt(), tab)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=valid[:, None, None, :])

    ms = time_ms(torch, lambda: pa.paged_decode_attention(
        q, kv, nxt(), tab, valid), args.iters)
    plain = time_ms(torch, lambda: pa.paged_decode_attention_plain(
        q, kv, nxt(), tab, valid), args.iters)
    lib = time_ms(torch, sdpa_decode, args.iters)
    # what these inputs need: each pool page some valid column of a row
    # maps, read once per leaf; q, the table, the valid plane, the output
    n_valid = int(valid.sum())
    pages = torch.unique(tab.long().repeat_interleave(pg, dim=1)[valid])
    nbytes = (pages.numel() * pg * kvh * hd * 2 * 2 + 2 * S * h * hd * 2
              + S * P * 4 + S * view_len)
    flops = 4.0 * n_valid * h * hd
    b_ms, b_by = bound_ms(nbytes, flops)
    records["paged_decode_attention"] = dict(
        source="distributed_tensorflow_tpu_torch/csrc/paged_attention.cu",
        replaces="distributed_tensorflow_tpu/ops/pallas/paged_attention.py:226",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib)
    log({"time": "paged_decode_attention", "shape": "q[8,1,12,64] "
         "pool[12,513,16,12,64] bf16", "valid_cols": n_valid,
         "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
         "bound_ms": b_ms, "bound_by": b_by})

    # --- paged window: one row, 32 queries, pos in {0, 96, 500}
    row = perm[-P:].to(torch.int32).contiguous()
    qw = torch.randn(1, 32, h, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    werr = 0.0
    for pos in (0, 96, 500):
        got = pa.paged_window_attention(qw, kv, 3, row, pos)
        want = pa.paged_window_attention_plain(qw, kv, 3, row, pos)
        e = (got.float() - want.float()).abs().max().item()
        log({"check": "paged_window_attention", "pos": pos, "dtype": "bf16",
             "max_abs_err": e, "tol": WINDOW_TOL})
        werr = max(werr, e)
    if not werr <= WINDOW_TOL:
        raise AssertionError(f"paged window kernel disagrees: {werr}")
    pos = 500
    wcol = torch.arange(view_len, device=dev)[None, :]
    wmask = (wcol <= pos + torch.arange(32, device=dev)[:, None])[None, None]

    def sdpa_window():
        k, v = pa.paged_layer_kv(kv, nxt(), row[None, :])
        return F.scaled_dot_product_attention(
            qw.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=wmask)

    ms = time_ms(torch, lambda: pa.paged_window_attention(
        qw, kv, nxt(), row, pos), args.iters)
    plain = time_ms(torch, lambda: pa.paged_window_attention_plain(
        qw, kv, nxt(), row, pos), args.iters)
    lib = time_ms(torch, sdpa_window, args.iters)
    last_col = min(pos + 31, view_len - 1)
    n_pages = len(set(row[:last_col // pg + 1].tolist()))
    nbytes = n_pages * pg * kvh * hd * 2 * 2 + 2 * 32 * h * hd * 2 + P * 4
    flops = 4.0 * sum(min(pos + j + 1, view_len) for j in range(32)) * h * hd
    b_ms, b_by = bound_ms(nbytes, flops)
    records["paged_window_attention"] = dict(
        source="distributed_tensorflow_tpu_torch/csrc/paged_attention.cu",
        replaces="distributed_tensorflow_tpu/ops/pallas/paged_attention.py:226",
        max_abs_err=werr, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib)
    log({"time": "paged_window_attention", "shape": "q[1,32,12,64] pos 500",
         "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
         "bound_ms": b_ms, "bound_by": b_by})
    del kv

    # --- LayerNorm at the window's and the decode tick's rows
    d = 768
    gamma = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    beta = 0.1 * torch.randn(d, generator=gen, device=dev)
    lerr = 0.0
    for rows in (256, 32, 8):
        x = (torch.randn(rows, d, generator=gen, device=dev) * 2 + 0.5).to(
            torch.bfloat16)
        got = fused.fused_layernorm(x, gamma, beta, 1e-5)
        want = fused.layernorm_plain(x, gamma, beta, 1e-5)
        e = (got.float() - want.float()).abs().max().item()
        g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
        ms = time_ms(torch, lambda: fused.fused_layernorm(
            x, gamma, beta, 1e-5), args.iters)
        plain = time_ms(torch, lambda: fused.layernorm_plain(
            x, gamma, beta, 1e-5), args.iters)
        lib = time_ms(torch, lambda: F.layer_norm(x, (d,), g16, b16, 1e-5),
                      args.iters)
        b_ms, b_by = bound_ms(rows * d * 2 * 2 + d * 4 * 2, 8.0 * rows * d)
        log({"check": "layernorm", "shape": [rows, d], "dtype": "bf16",
             "max_abs_err": e, "tol": LN_TOL, "kernel_ms": ms,
             "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
             "bound_by": b_by})
        lerr = max(lerr, e)
        if rows == 8:
            records["layernorm"] = dict(
                source="distributed_tensorflow_tpu_torch/csrc/layernorm.cu",
                replaces="distributed_tensorflow_tpu/ops/pallas/fused.py:161",
                max_abs_err=lerr, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)
    if not lerr <= LN_TOL:
        raise AssertionError(f"layernorm kernel disagrees: {lerr}")
    records["layernorm"]["max_abs_err"] = lerr
    torch.cuda.synchronize()
    return records


def _err_and_scale(torch, got, want):
    """(max |got - want| over want's finite entries, max(1, max |want|));
    the error is inf if the two disagree on which entries are finite (a
    row with no unmasked key has lse -inf)."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        return float("inf"), 1.0
    if not fin.any():
        return 0.0, 1.0
    return ((got[fin] - want[fin]).abs().max().item(),
            max(1.0, want[fin].abs().max().item()))


def _flash_case(torch, fa, gen, b, s, h, hk, hd, dtype, masked):
    """Flash forward, dK/dV and dQ (causal) at one shape against their
    plain versions: returns {kernel: (max abs err, tol)} and the operands
    (q, k, v, do, lse, dvec)."""
    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)
    q, k, v, do = rnd(b, s, h, hd), rnd(b, s, hk, hd), rnd(b, s, hk, hd), \
        rnd(b, s, h, hd)
    valid = None
    if masked:
        valid = torch.rand(b, s, generator=gen, device=dev) < 0.7
        valid[0] = False                   # batch row 0: no valid key
        valid[1:, 0] = True
    out, lse = fa.flash_forward(q, k, v, valid, True)
    dvec = fa.row_dot(do, out)
    pairs = {
        "flash_forward": zip((out, lse), fa.flash_forward_plain(
            q, k, v, valid, True)),
        "flash_backward_dkv": zip(
            fa.flash_backward_dkv(q, k, v, valid, do, lse, dvec, True),
            fa.flash_backward_dkv_plain(q, k, v, valid, do, lse, dvec,
                                        True)),
        "flash_backward_dq": [(
            fa.flash_backward_dq(q, k, v, valid, do, lse, dvec, True),
            fa.flash_backward_dq_plain(q, k, v, valid, do, lse, dvec,
                                       True))]}
    rel = FLASH_BF16_TOL if dtype == torch.bfloat16 else FLASH_F32_TOL
    result = {}
    for name, ps in pairs.items():
        errs = [_err_and_scale(torch, got, want) for got, want in ps]
        result[name] = (max(e for e, _ in errs),
                        rel * max(sc for _, sc in errs))
    torch.cuda.synchronize()
    return result, (q, k, v, do, lse, dvec)


def check_train_kernels(torch, args):
    """Phase 3, the training kernels: returns {kernel name: record}."""
    import torch.nn.functional as F

    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.kernels import fused

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed + 1)
    records = {}
    site = "distributed_tensorflow_tpu/ops/pallas/flash_attention.py:"
    replaces = {"flash_forward": site + "169",
                "flash_backward_dkv": site + "346",
                "flash_backward_dq": site + "379"}

    # agreement at the training shape, at s 1024, and on an f32 case with
    # GQA (12 query heads on 4 kv heads), a kv-valid plane with fully
    # masked rows, a length no tile divides and head dim 128
    worst = dict.fromkeys(replaces, 0.0)
    main = None
    for label, shape in (
            ("train", (TRAIN_BATCH, TRAIN_SEQ, 12, 12, 64, torch.bfloat16,
                       False)),
            ("s1024", (12, 1024, 12, 12, 64, torch.bfloat16, False)),
            ("f32_gqa_valid_ragged_hd128", (3, 300, 12, 4, 128,
                                            torch.float32, True))):
        result, ops = _flash_case(torch, fa, gen, *shape)
        for name, (err, tol) in result.items():
            log({"check": name, "case": label, "max_abs_err": err,
                 "tol": tol})
            if not err <= tol:
                raise AssertionError(f"{name} disagrees ({label}): "
                                     f"{err} > {tol}")
            worst[name] = max(worst[name], err)
        if label == "train":
            main = ops
        del ops

    # times at the training shape; the library call is SDPA, causal
    q, k, v, do, lse, dvec = main
    b, s, h, hd = q.shape
    iters = max(20, args.iters // 4)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
        iters)
    tensor = q.numel() * q.element_size()     # q, k, v, o, do, dq, dk, dv
    row = b * h * s * 4                       # lse or D, f32
    pairs = 0.5 * b * h * s * s * hd          # causal: half of s x s
    work = {  # (bytes each input read once + output written once, flops)
        "flash_forward": (4 * tensor + row, 4 * pairs),
        "flash_backward_dkv": (6 * tensor + 2 * row, 8 * pairs),
        "flash_backward_dq": (5 * tensor + 2 * row, 6 * pairs)}
    calls = {
        "flash_forward": (
            lambda: fa.flash_forward(q, k, v, None, True),
            lambda: fa.flash_forward_plain(q, k, v, None, True), lib_fwd),
        "flash_backward_dkv": (
            lambda: fa.flash_backward_dkv(q, k, v, None, do, lse, dvec,
                                          True),
            lambda: fa.flash_backward_dkv_plain(q, k, v, None, do, lse,
                                                dvec, True), lib_bwd),
        "flash_backward_dq": (
            lambda: fa.flash_backward_dq(q, k, v, None, do, lse, dvec, True),
            lambda: fa.flash_backward_dq_plain(q, k, v, None, do, lse, dvec,
                                               True), lib_bwd)}
    for name, (kern, plain, lib) in calls.items():
        ms = time_ms(torch, kern, iters)
        plain_ms = time_ms(torch, plain, max(5, iters // 10))
        b_ms, b_by = bound_ms(*work[name])
        records[name] = dict(
            source="distributed_tensorflow_tpu_torch/csrc/flash_attention.cu",
            replaces=replaces[name], max_abs_err=worst[name], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        log({"time": name, "shape": f"q[{b},{s},{h},{hd}] bf16 causal",
             "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib,
             "library": "F.scaled_dot_product_attention(is_causal=True)"
             + ("" if name == "flash_forward" else
                " backward, dq dk dv together"),
             "bound_ms": b_ms, "bound_by": b_by})
    del main, q, k, v, do, lse, dvec, qt, kt, vt, lib_out

    # Adam on the word embedding and one [768, 3072] kernel, called as the
    # optimizer calls it (delta out, moments in place, decay folded in)
    kw = dict(lr=TRAIN_LR, weight_decay=0.01, tf14_eps=True,
              return_delta=True)
    adam_err = 0.0
    for shape in ((50257, 768), (768, 3072)):
        p, g, m = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
        v = torch.rand(shape, generator=gen, device=dev)
        want = fused.adam_plain(p, g, m, v, 3, **kw)
        m2, v2 = m.clone(), v.clone()
        got = fused.fused_adam_update(p, g, m2, v2, 3, out=(None, m2, v2),
                                      **kw)
        torch.cuda.synchronize()
        err = max((x - y).abs().max().item() for x, y in zip(got, want))
        log({"check": "fused_adam", "shape": list(shape),
             "max_abs_err": err, "tol": ADAM_TOL})
        if not err <= ADAM_TOL:
            raise AssertionError(f"Adam kernel disagrees: {err}")
        adam_err = max(adam_err, err)
        ms = time_ms(torch, lambda: fused.fused_adam_update(
            p, g, m2, v2, 3, out=(None, m2, v2), **kw), args.iters)
        plain = time_ms(torch, lambda: fused.adam_plain(
            p, g, m2, v2, 3, out=(None, m2, v2), **kw), iters)
        lib_p = p.clone()
        lib_p.grad = g
        lib_opt = torch.optim.AdamW([lib_p], lr=TRAIN_LR, eps=1e-8,
                                    weight_decay=0.01, fused=True)
        lib = time_ms(torch, lib_opt.step, args.iters)
        # 4 f32 streams in, 3 out; about 12 flops an element
        b_ms, b_by = bound_ms(28.0 * p.numel(), 12.0 * p.numel())
        log({"time": "fused_adam", "shape": list(shape), "kernel_ms": ms,
             "plain_ms": plain, "library_ms": lib,
             "library": "torch.optim.AdamW(fused=True).step()",
             "bound_ms": b_ms, "bound_by": b_by})
        if "fused_adam" not in records:      # the word embedding's times
            records["fused_adam"] = dict(
                source="distributed_tensorflow_tpu_torch/csrc/adam.cu",
                replaces="distributed_tensorflow_tpu/ops/pallas/fused.py:119",
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib)
        del p, g, m, v, m2, v2, want, got, lib_p, lib_opt
    records["fused_adam"]["max_abs_err"] = adam_err
    torch.cuda.synchronize()
    return records


def _requests(np, seed):
    """12 requests: 4 share a 256-token system prompt (the first goes in
    first, the other 3 last), 8 are independent; budgets 8-64 new
    tokens."""
    rng = np.random.default_rng(seed)
    vocab = 50257

    def toks(n):
        return rng.integers(0, vocab, int(n), dtype=np.int32)

    system = toks(256)
    shared = [np.concatenate([system, toks(rng.integers(16, 49))])
              for _ in range(4)]
    own = [toks(n) for n in rng.integers(16, 701, 8)]
    prompts = [shared[0]] + own + shared[1:]
    budgets = [int(b) for b in rng.integers(8, 65, len(prompts))]
    return prompts, budgets


def run_engine(torch, model, prompts, budgets, late=0):
    """Serve ``prompts`` on a fresh engine and drain it.  The last
    ``late`` requests are submitted once the first one has its first
    token (its prompt pages are then in the radix cache)."""
    from distributed_tensorflow_tpu_torch import Engine
    eng = Engine(model, device=model.device, num_slots=8, max_len=1024,
                 prefill_chunk=32, tick_steps=8)
    n = len(prompts) - late
    t0 = time.perf_counter()
    hs = [eng.submit(p, b) for p, b in zip(prompts[:n], budgets[:n])]
    while late and not hs[0].tokens:
        eng.step()
    hs += [eng.submit(p, b) for p, b in zip(prompts[n:], budgets[n:])]
    eng.drain()
    torch.cuda.synchronize()
    return eng, hs, time.perf_counter() - t0


def check_engine(torch, np, args, smi):
    """Phase 4: returns the launch counts of the main path's run."""
    from distributed_tensorflow_tpu_torch import GPT, gpt_small
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa

    model = GPT(gpt_small(dtype=torch.bfloat16), device="cuda",
                generator=torch.Generator("cuda").manual_seed(args.seed))
    prompts, budgets = _requests(np, args.seed)
    pa.LAUNCHES.clear()
    fused.LAUNCHES.clear()
    eng, hs, wall = run_engine(torch, model, prompts, budgets,
                                late=3)
    launches = {"paged_decode_attention": pa.LAUNCHES["paged_decode"],
                "paged_window_attention": pa.LAUNCHES["paged_window"],
                "layernorm": fused.LAUNCHES["layernorm"]}
    st = eng.stats()
    for h, b in zip(hs, budgets):
        if h.status != "ok" or len(h.tokens) != b:
            raise AssertionError(f"request {h.rid}: status {h.status}, "
                                 f"{len(h.tokens)} of {b} tokens")
    if not st.prefix_hit_rate > 0:
        raise AssertionError("no prefix-cache hit")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    ttft = sorted(h.ttft_s for h in hs)
    n_tok = sum(len(h.tokens) for h in hs)
    log({"engine": "gpt2-small bf16", "requests": len(hs),
         "prompt_tokens": int(sum(p.size for p in prompts)),
         "new_tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
         "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
         "prefix_hit_rate": st.prefix_hit_rate,
         "prefill_windows_skipped": st.prefill_windows_skipped_total,
         "launches": launches, "card": smi})
    del eng

    # row independence: alone == in the batch == on a prefix hit
    hit = len(prompts) - 1             # a shared-prompt request that hit
    own = 1
    for idx in (own, hit):
        _, (h,), _ = run_engine(torch, model, [prompts[idx]],
                                [budgets[idx]])
        if h.tokens != hs[idx].tokens:
            raise AssertionError(f"request {idx} alone differs from batch")
    eng, _, _ = run_engine(torch, model, [prompts[0]], [budgets[0]])
    h = eng.submit(prompts[hit], budgets[hit])
    eng.drain()
    if eng.stats().prefix_hits_total != 1 or h.tokens != hs[hit].tokens:
        raise AssertionError("prefix-hit tokens differ from the batch")
    log({"row_independence": "ok", "checked": [own, hit]})
    return launches


def check_reference(torch, np):
    """Phase 5: the card's kernels and the CPU's plain versions decode the
    same greedy tokens from the same f32 weights."""
    from distributed_tensorflow_tpu_torch import GPT, Engine, gpt_tiny
    gpu = GPT(gpt_tiny(), device="cuda")
    cpu = GPT(gpt_tiny(), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n, dtype=np.int32) for n in (5, 17, 40)]
    outs = []
    for model, device in ((gpu, "cuda"), (cpu, "cpu")):
        eng = Engine(model, device=device, num_slots=2, max_len=128,
                     prefill_chunk=16, tick_steps=4)
        outs.append(eng.generate_batch(prompts, 12))
    if outs[0] != outs[1]:
        raise AssertionError(f"card and CPU reference disagree: {outs}")
    log({"reference": "ok", "requests": len(prompts)})


def _train_setup(torch, model, lr, seed):
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step)
    params = dict(model.named_parameters())
    opt = adamw(lr)
    state = TrainState.create(params, opt.init(params))
    step = make_custom_train_step(model.lm_loss_fn(), opt, seed=seed,
                                  grad_clip_norm=1.0)
    return state, step


def _train_batch(torch, np, seed, batch, seq, vocab, device):
    """Rows of seq + 1 ids drawn with numpy, as the JAX package's bench
    row draws them; the loss shifts them into inputs and targets."""
    ids = np.random.default_rng(seed).integers(0, vocab, (batch, seq + 1))
    return {"input_ids": torch.from_numpy(ids.astype(np.int32)).to(device)}


def _model_flops(model, tokens, seq):
    """Training flops of one step: 6 N T for the matrix products (N: the
    parameters a token's products touch, the tied head included, the
    position table not) plus causal attention, 3 x 2 h hd s^2 per
    sequence and layer (QK^T and PV, half of the s x s pairs)."""
    c = model.config
    n = sum(p.numel() for name, p in model.named_parameters()
            if name != "position")
    attn = 6.0 * c.num_layers * c.num_heads * c.head_dim * seq * tokens
    return 6.0 * n * tokens + attn


def check_training(torch, np, args, smi):
    """Phase 6, the main path of this slice: returns the launch counts of
    the training kernels over the phase and the trained model."""
    from distributed_tensorflow_tpu_torch import GPT, gpt_small
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.kernels import fused

    model = GPT(gpt_small(dtype=torch.bfloat16, dropout_rate=0.0),
                device="cuda",
                generator=torch.Generator("cuda").manual_seed(args.seed))
    state, step = _train_setup(torch, model, TRAIN_LR, args.seed)
    batch = _train_batch(torch, np, args.seed, TRAIN_BATCH, TRAIN_SEQ,
                         model.config.vocab_size, "cuda")
    n_params = len(state.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.clear()
    fused.LAUNCHES.clear()
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, batch)
        timed.append(metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_forward": fa.LAUNCHES["flash_forward"],
                "flash_backward_dkv": fa.LAUNCHES["flash_backward_dkv"],
                "flash_backward_dq": fa.LAUNCHES["flash_backward_dq"],
                "layernorm": fused.LAUNCHES["layernorm"],
                "fused_adam": fused.LAUNCHES["adam"]}
    losses += [m["loss"].item() for m in timed]
    c = model.config
    steps = TRAIN_WARMUP + TRAIN_STEPS
    per_step = {"flash_forward": c.num_layers,
                "flash_backward_dkv": c.num_layers,
                "flash_backward_dq": c.num_layers,
                "layernorm": 2 * c.num_layers + 1, "fused_adam": n_params}
    step_ms = wall / TRAIN_STEPS * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _model_flops(model, tokens, TRAIN_SEQ)
    log({"training": "gpt2-small bf16", "batch": TRAIN_BATCH,
         "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "step_ms": step_ms,
         "tokens_per_s": tokens / (step_ms / 1e3),
         "mfu": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
         "model_tflop_per_step": flops / 1e12,
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
         "losses": losses, "grad_norm_last": timed[-1]["grad_norm"].item(),
         "launches": launches,
         "launches_per_step": per_step, "parameter_tensors": n_params,
         "card": smi})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    for name, n in launches.items():
        if n != per_step[name] * steps:
            raise AssertionError(f"{name}: {n} launches, expected "
                                 f"{per_step[name]} x {steps}")
    return launches, model


def check_train_reference(torch, np):
    """Phase 7: 3 f32 gpt_tiny steps on the card (kernels) and on the CPU
    (plain versions) from the same weights agree."""
    from distributed_tensorflow_tpu_torch import GPT, gpt_tiny
    init = GPT(gpt_tiny(), device="cpu").state_dict()
    runs = []
    for device in ("cuda", "cpu"):
        model = GPT(gpt_tiny(dropout_rate=0.0), device=device)
        model.load_state_dict(init)
        state, step = _train_setup(torch, model, TRAIN_LR, 0)
        batch = _train_batch(torch, np, 1, 4, 32, 512, device)
        losses = []
        for _ in range(3):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
        runs.append((losses, {k: p.detach().cpu()
                              for k, p in state.params.items()}))
    (card_l, card_p), (cpu_l, cpu_p) = runs
    loss_err = max(abs(a - b) for a, b in zip(card_l, cpu_l))
    param_err = max((card_p[k] - cpu_p[k]).abs().max().item()
                    for k in cpu_p)
    log({"train_reference": "gpt_tiny f32, 3 steps", "card_losses": card_l,
         "cpu_losses": cpu_l, "loss_err": loss_err, "loss_tol":
         TRAIN_LOSS_TOL, "param_err": param_err,
         "param_tol": TRAIN_PARAM_TOL})
    if not (loss_err <= TRAIN_LOSS_TOL and param_err <= TRAIN_PARAM_TOL):
        raise AssertionError("card and CPU training disagree")


def check_train_then_serve(torch, np, model):
    """Phase 8: the trained weights serve through Engine, with no
    autograd graph."""
    from distributed_tensorflow_tpu_torch import Engine
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 50257, n, dtype=np.int32) for n in (40, 130)]
    budgets = [8, 16]
    eng = Engine(model, device=model.device, num_slots=2, max_len=256,
                 prefill_chunk=32, tick_steps=4)
    hs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    eng.drain()
    for h, b in zip(hs, budgets):
        if h.status != "ok" or len(h.tokens) != b:
            raise AssertionError(f"request {h.rid}: status {h.status}, "
                                 f"{len(h.tokens)} of {b} tokens")
    c = model.config
    kv = {n: torch.zeros(c.num_layers, 3, 16, c.kv_heads, c.head_dim,
                         dtype=c.dtype, device=model.device)
          for n in ("k", "v")}
    logits, _ = model.decode_window_paged(
        kv, torch.from_numpy(prompts[0][None, :16]).to(model.device),
        torch.tensor([1, 2], dtype=torch.int32, device=model.device), 0)
    if logits.requires_grad or any(p.grad is not None
                                   for p in model.parameters()):
        raise AssertionError("serving built an autograd graph")
    log({"train_then_serve": "ok", "tokens": [len(h.tokens) for h in hs]})


def profile_engine(torch, np, args, smi):
    """``--profile DIR``: the engine phase's requests once more under
    ``torch.profiler``; writes the kernel table to DIR/profile.txt and
    prints the device's busy share and the top kernels by device time."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_tpu_torch import GPT, gpt_small
    model = GPT(gpt_small(dtype=torch.bfloat16), device="cuda",
                generator=torch.Generator("cuda").manual_seed(args.seed))
    prompts, budgets = _requests(np, args.seed)
    run_engine(torch, model, prompts[:2], budgets[:2])        # warm-up
    _, _, plain_wall = run_engine(torch, model, prompts, budgets, late=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = run_engine(torch, model, prompts, budgets, late=3)
    rows = _kernel_rows(prof)
    busy_s = sum(r[1] for r in rows) / 1e6
    os.makedirs(args.profile, exist_ok=True)
    with open(os.path.join(args.profile, "profile.txt"), "w") as f:
        f.write(f"{smi}\nwall_s {wall} (unprofiled {plain_wall})\n")
        for key, us, n in rows:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key}\n")
    log({"profile": {"wall_s": wall, "unprofiled_wall_s": plain_wall,
                     "device_busy_s": busy_s,
                     "busy_share_of_unprofiled_wall": busy_s / plain_wall,
                     "top": [[k[:80], us / 1e3, n] for k, us, n in rows[:12]],
                     "card": smi}})


# kernel-name marks of the step's parts, first match wins
_TRAIN_PARTS = (
    ("GEMMs on cuBLAS's align1 path (the vocab-50257 tied head)",
     ("align1",)),
    ("other GEMMs", ("nvjet", "gemm", "Gemm")),
    ("flash attention (ours)", ("flash_",)),
    ("log-softmax and its gradient", ("SoftMax",)),
    ("Adam (ours)", ("adam_",)),
    ("LayerNorm forward (ours)", ("layernorm_kernel",)),
)


def profile_training(torch, np, args, smi):
    """``--profile DIR``: 3 training steps of the phase-6 configuration
    under ``torch.profiler`` after 2 unprofiled ones; writes the kernel
    table to DIR/profile_train.txt and prints the device's busy share and
    the top kernels."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_tpu_torch import GPT, gpt_small
    model = GPT(gpt_small(dtype=torch.bfloat16, dropout_rate=0.0),
                device="cuda",
                generator=torch.Generator("cuda").manual_seed(args.seed))
    state, step = _train_setup(torch, model, TRAIN_LR, args.seed)
    batch = _train_batch(torch, np, args.seed, TRAIN_BATCH, TRAIN_SEQ,
                         model.config.vocab_size, "cuda")
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    rows = _kernel_rows(prof)
    busy_s = sum(r[1] for r in rows) / 1e6
    parts = {}
    for key, us, _ in rows:
        part = next((name for name, marks in _TRAIN_PARTS
                     if any(m in key for m in marks)),
                    "elementwise, reductions, copies")
        parts[part] = parts.get(part, 0.0) + us / 1e3 / 3
    os.makedirs(args.profile, exist_ok=True)
    with open(os.path.join(args.profile, "profile_train.txt"), "w") as f:
        f.write(f"{smi}\n3 steps, unprofiled wall_s {plain_wall}\n")
        for key, us, n in rows:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key}\n")
    log({"profile_train": {
        "steps": 3, "unprofiled_wall_s": plain_wall, "device_busy_s": busy_s,
        "busy_share_of_unprofiled_wall": busy_s / plain_wall,
        "kernels_per_step": sum(r[2] for r in rows) / 3,
        "device_ms_per_step_by_part": dict(sorted(
            parts.items(), key=lambda kv: -kv[1])),
        "top": [[k[:80], us / 1e3, n] for k, us, n in rows[:15]],
        "card": smi}})


def _kernel_rows(prof):
    """(kernel name, device us, count) rows of a profile, largest first:
    kernels only, since an operator's row repeats its kernels' time."""
    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else e.self_cuda_time_total
    return sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and dev_us(e) > 0), key=lambda r: -r[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the engine and training phases; "
                    "tables to DIR")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from distributed_tensorflow_tpu_torch.ops.kernels import _build

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    log({"phase": "device", "name": name, "count": count, "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda})

    secs = _build.build()
    log({"phase": "build", "seconds": secs, "dir": str(_build.BUILD_DIR)})

    records = check_kernels(torch, args)
    records.update(check_train_kernels(torch, args))
    launches = check_engine(torch, np, args, smi)
    check_reference(torch, np)
    train_launches, model = check_training(torch, np, args, smi)
    launches.update((k, v) for k, v in train_launches.items()
                    if k != "layernorm")     # its record: serving shapes
    check_train_reference(torch, np)
    check_train_then_serve(torch, np, model)
    del model
    if args.profile:
        profile_engine(torch, np, args, smi)
        profile_training(torch, np, args, smi)

    kernels = [dict(name=k, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=launches[k],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for k, r in records.items()]
    log({"total_s": time.perf_counter() - t_start})
    log({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
