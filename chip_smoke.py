#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--iters N] [--profile DIR]

Phases, in order; any failure ends the run with a non-zero exit code and
no result lines:

1. device: requires CUDA; prints the card's name, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build: compiles every CUDA source of the port (one nvcc each, all at
   once) and prints the seconds.
3. kernels: each kernel at the serving path's shapes (GPT-2 small, bf16,
   8 slots, pages of 16, max_len 1024, prefill windows of 32) against its
   plain PyTorch version on the card, with the tolerance; times the
   kernel, the plain version and one PyTorch library call computing the
   same function (CUDA events over many launches), and computes the
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
6. with ``--profile DIR`` only: the engine phase again under
   ``torch.profiler``; the device's busy share and its top kernels.

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
    events = prof.key_averages()

    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else e.self_cuda_time_total
    # kernels only: an operator's row repeats its kernels' device time
    rows = sorted(((e.key, dev_us(e), e.count) for e in events
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and dev_us(e) > 0), key=lambda r: -r[1])
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the engine phase; table to DIR")
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
    launches = check_engine(torch, np, args, smi)
    check_reference(torch, np)
    if args.profile:
        profile_engine(torch, np, args, smi)

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
