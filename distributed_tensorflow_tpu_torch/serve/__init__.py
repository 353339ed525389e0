"""The serving tier of the port: page pool, contiguous slot cache, LoRA
adapter table, slot scheduler, engine."""
from .adapters import AdapterTable, AdapterTableFull
from .engine import (DrainResult, Engine, EngineStats, QueueFullError,
                     RequestHandle, RequestSnapshot)
from .pages import PagePool, PagePoolExhausted, auto_page_size
from .scheduler import Request, SlotScheduler

__all__ = ["AdapterTable", "AdapterTableFull", "DrainResult", "Engine",
           "EngineStats", "PagePool", "PagePoolExhausted", "QueueFullError",
           "Request", "RequestHandle", "RequestSnapshot", "SlotScheduler",
           "auto_page_size"]
