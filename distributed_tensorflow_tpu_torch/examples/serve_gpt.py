"""GPT serving demo, in PyTorch: the port of ``examples/serve_gpt.py``.

    python -m distributed_tensorflow_tpu_torch.examples.serve_gpt
        [--device=cuda] [--new_tokens=32] [--batch=4] [--seed=0]
        [--metrics_port=0] [--engine] [--replicas=1] [--shared_prefix]

Runs a small randomly initialized GPT (d 128, 4 layers of 4 heads of
32, vocab 512; structure, not quality) through every decode path of the
serving tier and prints tokens/s for each, in the JAX script's lines:

  * greedy, sampled (T=0.8, top_p=0.9) and ragged-prompt ``generate``,
    beam search and the chunked prefill;
  * weight-only int8 (``ops.quant``), then int8 weights with an int8 KV
    cache, each with its greedy agreement against the f32 run;
  * ``--engine``: the same greedy, sampled and ragged requests through
    the paged ``Engine``, with engine == lock-step greedy;
  * ``--shared_prefix``: the radix prefix cache's TTFT delta and hits;
  * ``--replicas=N`` (N >= 2): N engines behind a ``fleet.Router``, two
    tenants, one under a hot-swapped LoRA adapter, with fleet ==
    lock-step greedy on the base-model rows;
  * speculative decoding with a layer-truncated draft (greedy match).

While it decodes it serves ``/metrics`` and ``/healthz`` on the loopback
(``obs.Telemetry``; ``--metrics_port=-1`` turns it off, 0 picks a port)
and scrapes itself once at the end.

The int8 weights are quantized in the JAX package's layout:
``quantize_tree``'s "auto" axes keep the first and last axis of a leaf
of three or more dims, so the scales of the stacked ``[L, ...]`` tree
(``models/convert.py gpt_params_to_jax``) are per layer stack, as in the
JAX script; the dequantized tree is carried back into a model once,
before the timed calls (the JAX script dequantizes inside its jitted
call).  ``serve_demo`` is the body, taking the model's state dict, so a
test can run it on the JAX demo's weights.

On the card every paged read runs the paged-attention kernel at head dim
32, every prompt prefill the flash forward (head dim 32 padded to 64)
and every norm the LayerNorm kernel.  ``--device`` is ``cuda`` by
default and raises when there is no card; ``--device=cpu`` runs the
kernels' plain versions.
"""
import dataclasses
import re
import sys
import time
from typing import Any, Callable, Dict, Mapping, Optional

from distributed_tensorflow_tpu_torch.utils import flags as flags_lib
from distributed_tensorflow_tpu_torch.utils.flags import FLAGS

PLEN = 8


def _define_flags() -> None:
    flags_lib.DEFINE_string(
        "device", "cuda",
        "'cuda' (the default; raises without a card) or 'cpu'")
    flags_lib.DEFINE_integer("new_tokens", 32, "tokens to generate per path")
    flags_lib.DEFINE_integer("batch", 4, "batch size for the batched paths")
    flags_lib.DEFINE_integer("seed", 0, "init/prompt seed")
    flags_lib.DEFINE_integer("metrics_port", 0,
                             "serve /metrics + /healthz during the demo "
                             "(0 = ephemeral port, -1 = off)")
    flags_lib.DEFINE_bool("engine", False,
                          "also run the greedy/sampled/ragged demos "
                          "through the continuous-batching engine")
    flags_lib.DEFINE_integer("replicas", 1,
                             ">= 2: also run a fleet demo: that many "
                             "engine replicas behind the fleet Router")
    flags_lib.DEFINE_bool("shared_prefix", False,
                          "also run the paged-KV radix-cache demo")


def demo_config(new_tokens: int):
    """(the demo's ``GPTConfig``, max_len): the JAX script's model."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTConfig
    max_len = PLEN + new_tokens + 8
    return GPTConfig(vocab_size=512, hidden_size=128, num_layers=4,
                     num_heads=4, intermediate_size=512,
                     max_position=max_len + 8, dropout_rate=0.0), max_len


def _path_label(name: str) -> str:
    return re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")


def serve_demo(state_dict: Mapping[str, Any], *, device, new: int,
               batch: int, seed: int, engine: bool = False,
               replicas: int = 1, shared_prefix: bool = False,
               telemetry=None) -> Dict[str, Any]:
    """The demo's body on the model whose weights are ``state_dict`` (the
    port's names): prints the JAX script's lines and returns the token
    arrays of every path (numpy, [b, plen + new]; the engine paths'
    lists of generated tokens)."""
    import numpy as np
    import torch

    from distributed_tensorflow_tpu_torch import fleet, serve
    from distributed_tensorflow_tpu_torch.models import convert
    from distributed_tensorflow_tpu_torch.models.gpt import GPT
    from distributed_tensorflow_tpu_torch.models.speculative import \
        generate_speculative
    from distributed_tensorflow_tpu_torch.ops import quant

    config, max_len = demo_config(new)
    b = batch
    plen = PLEN

    def model_of(cfg, sd):
        m = GPT(cfg, device=device)
        m.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
        return m

    model = model_of(config, state_dict)
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, config.vocab_size, (b, plen)).astype(np.int32)
    results: Dict[str, Any] = {}

    def host(out):
        if isinstance(out, tuple):
            return tuple(host(o) for o in out)
        return out.cpu().numpy() if isinstance(out, torch.Tensor) else out

    def record(name, tokens_out, dt, histogram=True):
        print(f"{name:<28} {tokens_out / dt:10,.0f} tok/s", flush=True)
        if telemetry is None:
            return
        # one label value per decode path; static cardinality
        path = _path_label(name)
        reg = telemetry.registry
        reg.counter("dttpu_decode_tokens_total",
                    "Tokens generated, by decode path.",
                    labels={"path": path}).inc(tokens_out)
        if histogram:
            reg.histogram("dttpu_decode_seconds",
                          "Wall time per timed decode call.",
                          labels={"path": path}).observe(dt)
        reg.gauge("dttpu_decode_tokens_per_second",
                  "Decode throughput, by path.",
                  labels={"path": path}).set(tokens_out / dt)

    def timed(name, fn: Callable, tokens_out):
        host(fn())                              # warm-up (builds kernels)
        t0 = time.perf_counter()
        out = host(fn())                        # value fetch closes it
        record(name, tokens_out, time.perf_counter() - t0)
        return out

    def gen(m, p, **kw):
        return m.generate(p, max_new_tokens=new, max_len=max_len, **kw)

    greedy = results["greedy"] = timed(
        "greedy generate", lambda: gen(model, prompt, temperature=0.0),
        b * new)
    results["sampled"] = timed(
        "sampled (T=0.8, top_p=0.9)",
        lambda: gen(model, prompt, temperature=0.8, top_p=0.9,
                    generator=torch.Generator(device).manual_seed(1)),
        b * new)

    valid = np.ones((b, plen), np.int32)
    valid[0, : plen // 2] = 0                    # one shorter prompt,
    ragged_prompt = prompt.copy()                # LEFT-padded
    ragged_prompt[0, : plen // 2] = 0
    results["ragged"] = timed(
        "ragged batch (prompt_valid)",
        lambda: gen(model, ragged_prompt, prompt_valid=valid), b * new)
    results["beam"] = timed(
        "beam search (beam=4)",
        lambda: model.beam_search(prompt, max_new_tokens=new, beam_size=4,
                                  max_len=max_len), b * new)
    results["chunked"] = timed(
        "chunked prefill (W=4)",
        lambda: gen(model, prompt, temperature=0.0, prefill_chunk=4),
        b * new)

    # weight-only int8 in the JAX tree's layout (per-layer-stack scales)
    jtree = convert.gpt_params_to_jax(model.state_dict(), config)
    qparams = quant.quantize_tree(quant._map(torch.from_numpy, jtree))
    deq = convert.gpt_params_from_jax(
        quant._map(lambda t: t.numpy(), quant.dequantize_tree(qparams)),
        config)
    q_model = model_of(config, deq)
    q_out = results["int8"] = timed(
        "int8 weights", lambda: gen(q_model, prompt, temperature=0.0),
        b * new)
    agree = float(np.mean(greedy[:, plen:] == q_out[:, plen:]))
    print(f"{'':<28} int8 greedy agreement {agree:.3f}", flush=True)

    kv8_model = model_of(dataclasses.replace(config, kv_cache_dtype="int8"),
                         deq)
    kv8_out = results["kv8"] = timed(
        "int8 weights + int8 KV cache",
        lambda: gen(kv8_model, prompt, temperature=0.0), b * new)
    agree8 = float(np.mean(greedy[:, plen:] == kv8_out[:, plen:]))
    print(f"{'':<28} full-int8 greedy agreement {agree8:.3f}", flush=True)
    results["agree"] = {"int8": agree, "kv8": agree8}

    reg = telemetry.registry if telemetry is not None else None
    if engine:
        # the continuous-batching engine: greedy must match the lock-step
        # greedy token for token; a ragged prompt is a shorter request
        def timed_engine(name, eng, plist, tokens_out):
            def run():
                handles = [eng.submit(p, new) for p in plist]
                eng.drain()          # the tokens are on the host: closes
                return handles
            run()                    # warm-up
            t0 = time.perf_counter()
            handles = run()
            record(name, tokens_out, time.perf_counter() - t0,
                   histogram=False)
            return handles

        eng = serve.Engine(model, device=device, num_slots=b,
                           max_len=max_len, prefill_chunk=4, tick_steps=4,
                           registry=reg)
        hs = timed_engine("engine greedy", eng, list(prompt), b * new)
        results["engine_greedy"] = [h.tokens for h in hs]
        agree_eng = float(np.mean([
            h.tokens == greedy[i, plen:].tolist()
            for i, h in enumerate(hs)]))
        results["agree"]["engine"] = agree_eng
        print(f"{'':<28} engine==lock-step greedy {agree_eng:.3f}",
              flush=True)

        eng_s = serve.Engine(model, device=device, num_slots=b,
                             max_len=max_len, prefill_chunk=4, tick_steps=4,
                             registry=reg, temperature=0.8, top_p=0.9,
                             generator=torch.Generator(device).manual_seed(1))
        timed_engine("engine sampled (T=0.8)", eng_s, list(prompt), b * new)

        ragged_rows = [ragged_prompt[0, plen // 2:]] + list(prompt[1:])
        hs = timed_engine("engine ragged", eng, ragged_rows, b * new)
        results["engine_ragged"] = [h.tokens for h in hs]

    if shared_prefix:
        # the paged radix cache: one system prompt shared by every request;
        # followers map its pages read-only and skip those windows
        eng_sp = serve.Engine(model, device=device, num_slots=b,
                              max_len=max_len, prefill_chunk=4, tick_steps=4,
                              page_size=serve.auto_page_size(max_len, 4),
                              registry=reg)
        eng_sp.submit(rng.integers(0, config.vocab_size, 6).astype(
            np.int32), 2)            # warm-up: the uncached TTFT stays cold
        eng_sp.drain()
        sys_prompt = rng.integers(0, config.vocab_size,
                                  2 * eng_sp.scheduler.page_size
                                  ).astype(np.int32)
        ttfts = []
        for i in range(b):
            tail = rng.integers(0, config.vocab_size,
                                2 + i).astype(np.int32)
            h = eng_sp.submit(np.concatenate([sys_prompt, tail]), new)
            eng_sp.drain()
            ttfts.append(h.ttft_s)
        st = eng_sp.stats()
        results["shared_prefix_stats"] = st
        cold_ms = ttfts[0] * 1e3
        hit_ms = sum(ttfts[1:]) / max(len(ttfts) - 1, 1) * 1e3
        print(f"{'shared-prefix (paged KV)':<28} ttft cold "
              f"{cold_ms:7.1f} ms -> hit {hit_ms:7.1f} ms "
              f"({cold_ms / max(hit_ms, 1e-9):.1f}x faster)",
              flush=True)
        print(f"{'':<28} prefix hits {st.prefix_hits_total}/"
              f"{st.prefix_lookups_total}, "
              f"{st.prefill_windows_skipped_total} prefill windows "
              f"skipped, {st.prefix_tokens_reused_total} tokens "
              f"reused, {st.pages_free}/{st.pages_total} pages free",
              flush=True)

    if replicas >= 2:
        # N engines behind one Router: least-loaded placement, two tenants
        # under fair share, tenant "pro" under a hot-swapped LoRA adapter;
        # adapter-free rows must still match the lock-step greedy output
        policy = fleet.TenantPolicy(quantum=8)
        router = fleet.Router(
            [serve.Engine(model, device=device, num_slots=b,
                          max_len=max_len, prefill_chunk=4, tick_steps=4,
                          registry=reg, tenancy=policy, adapter_capacity=2,
                          adapter_rank=4)
             for _ in range(replicas)],
            registry=reg)
        router.load_adapter("pro-tuned", model.init_lora(
            torch.Generator(device).manual_seed(11), rank=4))

        def fleet_round():
            handles = []
            for i, p in enumerate(prompt):
                tenant = "pro" if i % 2 else "free"
                handles.append(router.submit(
                    p, new, tenant=tenant,
                    adapter_id="pro-tuned" if tenant == "pro" else None))
            router.drain()
            return handles

        fleet_round()                            # warm-up
        t0 = time.perf_counter()
        hs = fleet_round()
        dt = time.perf_counter() - t0
        print(f"{'fleet (%d replicas)' % replicas:<28} "
              f"{b * new / dt:10,.0f} tok/s", flush=True)
        base_rows = [i for i in range(b) if i % 2 == 0]
        agree_fleet = float(np.mean([
            hs[i].tokens == greedy[i, plen:].tolist() for i in base_rows]))
        results["agree"]["fleet"] = agree_fleet
        spread = {r: sum(1 for _, rid in router.placements if rid == r)
                  for r in router.replica_ids}
        print(f"{'':<28} fleet==lock-step greedy {agree_fleet:.3f} "
              f"(base-model rows), placements {spread}", flush=True)

    draft_config = dataclasses.replace(config, num_layers=2)
    draft = model_of(draft_config, {
        k: v for k, v in model.state_dict().items()
        if not k.startswith("blocks.") or int(k.split(".")[1]) < 2})
    spec_out, acc = results["spec"] = timed(
        "speculative (gamma=4)",
        lambda: generate_speculative(model, draft, prompt[:1],
                                     max_new_tokens=new, gamma=4), new)
    match = float(np.mean(greedy[:1, plen:] == spec_out[:, plen:]))
    results["agree"]["spec"] = match
    print(f"{'':<28} spec acceptance {float(acc):.3f}, greedy match "
          f"{match:.3f}", flush=True)
    if telemetry is not None:
        # self-scrape: the endpoint a scraper would hit is live and
        # carries the decode series recorded above
        import urllib.request
        with urllib.request.urlopen(telemetry.metrics_url(),
                                    timeout=5) as resp:
            text = resp.read().decode("utf-8")
        samples = [ln for ln in text.splitlines()
                   if ln and not ln.startswith("#")]
        print(f"{'':<28} /metrics scrape: {len(samples)} samples",
              flush=True)
    return results


def main(argv: Optional[list] = None) -> int:
    _define_flags()
    FLAGS.reset()
    FLAGS.parse(argv)

    import torch

    from distributed_tensorflow_tpu_torch import obs
    from distributed_tensorflow_tpu_torch._launch import start
    from distributed_tensorflow_tpu_torch.models.gpt import GPT
    from distributed_tensorflow_tpu_torch.parallel import cluster

    device = start(FLAGS.device, cluster.cluster_from_env())
    telemetry = None
    if FLAGS.metrics_port >= 0:
        telemetry = obs.Telemetry(metrics_port=FLAGS.metrics_port,
                                  service="serve").start()
        print(f"telemetry: {telemetry.metrics_url()} (+ /healthz)",
              flush=True)
    try:
        config, _ = demo_config(FLAGS.new_tokens)
        model = GPT(config, device=device,
                    generator=torch.Generator(device).manual_seed(FLAGS.seed))
        serve_demo(model.state_dict(), device=device, new=FLAGS.new_tokens,
                   batch=FLAGS.batch, seed=FLAGS.seed, engine=FLAGS.engine,
                   replicas=FLAGS.replicas,
                   shared_prefix=FLAGS.shared_prefix, telemetry=telemetry)
    finally:
        if telemetry is not None:
            telemetry.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
