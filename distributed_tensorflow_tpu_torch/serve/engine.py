"""Engine façade: submit() -> handle, streaming callbacks.

Counterpart of ``distributed_tensorflow_tpu/serve/engine.py`` without
its metrics registry, tenancy, adapters or migration; ``paged=False``
serves from contiguous per-slot stripes instead of the page pool::

    from distributed_tensorflow_tpu_torch import GPT, Engine, gpt_small

    model = GPT(gpt_small(dtype=torch.bfloat16))        # on the card
    eng = Engine(model, num_slots=8, max_len=1024, prefill_chunk=32)
    h = eng.submit(prompt_ids, max_new_tokens=64,
                   on_token=lambda toks: print(toks))
    eng.drain()                     # or pump eng.step() yourself
    h.tokens                        # the generated ids (incl. EOS)

The engine is synchronous: the caller pumps ``step()``/``drain()``.  It
runs on the card unless built with ``device="cpu"``, and raises when
asked for a card that is not there.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch

from ..models.gpt import resolve_device
from .scheduler import EngineStats, Request, SlotScheduler

__all__ = ["Engine", "EngineStats", "RequestHandle"]


class RequestHandle:
    """Caller-facing view of one request."""

    def __init__(self, req: Request, engine: "Engine"):
        self._req = req
        self._engine = engine

    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def tokens(self) -> List[int]:
        """Generated ids so far (includes the EOS token when one fired)."""
        return list(self._req.tokens)

    @property
    def done(self) -> bool:
        return self._req.done.is_set()

    @property
    def status(self) -> str:
        """``pending`` while in flight; then ``ok`` | ``failed`` |
        ``cancelled``."""
        return self._req.status

    @property
    def error(self) -> Optional[BaseException]:
        return self._req.error

    @property
    def ttft_s(self) -> Optional[float]:
        return self._req.ttft_s

    @property
    def decode_s(self) -> Optional[float]:
        if self._req.first_token_time is None \
                or self._req.finish_time is None:
            return None
        return self._req.finish_time - self._req.first_token_time

    def result(self) -> List[int]:
        """Pump the engine until this request finishes; return its
        tokens.  (Synchronous engine: waiting IS driving.)"""
        while not self.done:
            if not self._engine.step():
                break
        return self.tokens


class Engine:
    """Continuous-batching serving engine over a paged (default) or
    contiguous KV cache.

    ``model`` is a port ``GPT`` on ``device`` (default ``"cuda"``).
    Keyword arguments go to ``SlotScheduler`` (num_slots, max_len,
    prefill_chunk, tick_steps, temperature/top_k/top_p, eos_id/pad_id,
    generator, paged, page_size/num_pages);
    ``default_max_new_tokens`` is the ``submit()`` budget when none is
    given.
    """

    def __init__(self, model, *, device: Union[str, torch.device] = "cuda",
                 default_max_new_tokens: int = 64, **scheduler_kwargs):
        device = resolve_device(device)
        if model.device.type != device.type or (
                device.index is not None and model.device != device):
            raise ValueError(f"model is on {model.device}, engine asked "
                             f"for {device}")
        self.device = model.device
        self.default_max_new_tokens = default_max_new_tokens
        self.scheduler = SlotScheduler(model, **scheduler_kwargs)

    def stats(self) -> EngineStats:
        return self.scheduler.stats()

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable[[List[int]], None]] = None
               ) -> RequestHandle:
        """Queue one prompt ([plen] ids, any length) -> handle;
        ``on_token`` streams each delivered token batch."""
        req = self.scheduler.submit(
            prompt, max_new_tokens or self.default_max_new_tokens,
            on_token=on_token)
        return RequestHandle(req, self)

    @property
    def busy(self) -> bool:
        return self.scheduler.busy

    def step(self) -> bool:
        """One scheduler tick; False when fully idle."""
        return self.scheduler.step()

    def drain(self) -> None:
        """Run until every submitted request has finished."""
        self.scheduler.drain()

    def cancel(self, handle: RequestHandle) -> bool:
        """Abort one request (status ``cancelled``); False if it already
        finished."""
        return self.scheduler.cancel(handle._req)

    def generate_batch(self, prompts,
                       max_new_tokens: Optional[int] = None
                       ) -> List[List[int]]:
        """Submit a list of prompts, drain, return each request's tokens
        in submission order.  If a submit raises, the handles already
        submitted are cancelled before the error propagates."""
        handles = []
        try:
            for p in prompts:
                handles.append(self.submit(p, max_new_tokens))
        except BaseException:
            for h in handles:
                self.scheduler.cancel(h._req)
            raise
        self.drain()
        return [h.tokens for h in handles]
