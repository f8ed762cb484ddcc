"""Tiny versions of the benchmark's configurations and mixes for CPU
tests: every width cut, the family and the file's other keys kept."""
import copy

from harness.cell import BENCH, load_json

MIX = {"loop": "closed", "slots": 32, "max_seq": 64,
       "prompt": {"dist": "uniform", "low": 2, "high": 8},
       "output": {"dist": "lognormal", "median": 40, "sigma": 0.3,
                  "low": 24, "high": 48},
       "schedule_seed": 0, "strata": 32, "warmup_steps": 5,
       "check_requests": 64,
       "check_steps": 16}

CONFIGS = ("minitron-8b", "phi3.5-moe-16L")


def config(name: str, dtype: str = None) -> dict:
    cfg = load_json(BENCH, "configs", f"{name}.json")
    cfg.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
               d_ff=128, vocab=256, init_std=0.125)
    if cfg["family"] == "moe":
        cfg.update(n_experts=4, top_k=2)
    if dtype:
        cfg["dtype"] = dtype
    return cfg


def mix() -> dict:
    return copy.deepcopy(MIX)
