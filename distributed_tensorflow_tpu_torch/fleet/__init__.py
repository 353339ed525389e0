"""The fleet tier of the port: per-tenant admission (``tenancy``) and the
page wire's framing (``pagewire``)."""
from .pagewire import (PageRecord, WireError, WireFrameError, frame_chunk,
                       parse_frame)
from .tenancy import (DeficitFairQueue, QuotaExceededError, TenantPolicy,
                      TenantQuota)

__all__ = ["DeficitFairQueue", "PageRecord", "QuotaExceededError",
           "TenantPolicy", "TenantQuota", "WireError", "WireFrameError",
           "frame_chunk", "parse_frame"]
