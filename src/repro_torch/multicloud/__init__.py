from repro_torch.multicloud.providers import multicloud_domain, NODE_CATALOG
from repro_torch.multicloud.dataset import OfflineDataset, build_dataset, Task
from repro_torch.multicloud.market import (
    MarketClock, MarketEvent, MarketOverlay, TickedBinding, eval_market,
    get_overlay, parse_schedule)

__all__ = ["multicloud_domain", "NODE_CATALOG", "OfflineDataset",
           "build_dataset", "Task", "MarketClock", "MarketEvent",
           "MarketOverlay", "TickedBinding", "eval_market", "get_overlay",
           "parse_schedule"]
