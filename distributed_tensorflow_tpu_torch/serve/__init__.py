"""The serving tier of the port: page pool, contiguous slot cache, slot
scheduler, engine."""
from .engine import Engine, EngineStats, RequestHandle
from .pages import PagePool, PagePoolExhausted, auto_page_size
from .scheduler import Request, SlotScheduler

__all__ = ["Engine", "EngineStats", "PagePool", "PagePoolExhausted",
           "Request", "RequestHandle", "SlotScheduler", "auto_page_size"]
