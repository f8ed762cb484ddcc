"""Table II provider/configuration spaces and node catalogs.

Spaces reproduce the paper's dataset exactly: AWS (family × size → 24 with
nodes), Azure (family × cpu_size → 16), GCP (family × type × vcpu → 48);
shared cluster-size parameter nodes ∈ {2,3,4,5}; 88 configs total.

Node attributes (vCPUs, memory, $/h) follow 2022 public on-demand price
lists for the respective VM types; per-provider speed/network factors encode
the CPU-generation and fabric differences the paper's measurements reflect.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.domain import Domain, ParamSpace, ProviderSpace

AWS, AZURE, GCP = "aws", "azure", "gcp"


def multicloud_domain() -> Domain:
    return Domain(
        providers=(
            ProviderSpace(AWS, (
                ParamSpace("family", ("m4", "r4", "c4")),
                ParamSpace("size", ("large", "xlarge")),
            )),
            ProviderSpace(AZURE, (
                ParamSpace("family", ("D_v2", "D_v3")),
                ParamSpace("cpu_size", (2, 4)),
            )),
            ProviderSpace(GCP, (
                ParamSpace("family", ("e2", "n1")),
                ParamSpace("type", ("standard", "highmem", "highcpu")),
                ParamSpace("vcpu", (2, 4)),
            )),
        ),
        shared=(ParamSpace("nodes", (2, 3, 4, 5)),),
    )


# node-type catalog: key -> (vcpus, mem_GB, price_per_hour, cpu_speed)
NODE_CATALOG: Dict[Tuple[str, tuple], Tuple[int, float, float, float]] = {}


def _aws(family: str, size: str):
    vcpus = 2 if size == "large" else 4
    mem = {"m4": 4.0, "r4": 7.625, "c4": 1.875}[family] * vcpus
    price = {"m4": 0.050, "r4": 0.0665, "c4": 0.0498}[family] * vcpus
    speed = {"m4": 1.00, "r4": 1.00, "c4": 1.18}[family]
    return vcpus, mem, price, speed


def _azure(family: str, cpu_size: int):
    mem = {"D_v2": 3.5, "D_v3": 4.0}[family] * cpu_size
    price = {"D_v2": 0.057, "D_v3": 0.048}[family] * cpu_size
    speed = {"D_v2": 0.92, "D_v3": 1.04}[family]
    return cpu_size, mem, price, speed


def _gcp(family: str, type_: str, vcpu: int):
    mem_per = {"standard": 4.0, "highmem": 8.0, "highcpu": 1.0}[type_]
    base = {"e2": 0.03351, "n1": 0.04749}[family]
    mem_price = {"e2": 0.00449, "n1": 0.00635}[family]
    mem = mem_per * vcpu
    price = base * vcpu + mem_price * mem
    speed = {"e2": 0.88, "n1": 1.00}[family]
    return vcpu, mem, price, speed


def node_attrs(provider: str, config: dict):
    """(vcpus, mem_GB, price/h, cpu_speed) for one node of this config."""
    if provider == AWS:
        return _aws(config["family"], config["size"])
    if provider == AZURE:
        return _azure(config["family"], config["cpu_size"])
    if provider == GCP:
        return _gcp(config["family"], config["type"], config["vcpu"])
    raise KeyError(provider)


# provider-level fabric/runtime factors (network seconds multiplier, and a
# per-provider scheduling overhead in seconds for cluster orchestration)
PROVIDER_NET = {AWS: 1.00, AZURE: 1.60, GCP: 0.85}
PROVIDER_OVERHEAD = {AWS: 25.0, AZURE: 45.0, GCP: 10.0}


# ---------------------------------------------------------------------------
# CherryPick-style numeric feature encodings.  CherryPick/Ernest describe
# configurations by instance ATTRIBUTES (cluster size, vCPUs, RAM, price) —
# not by categorical identity — which imposes smoothness across VM types
# that real measurements do not have; the hierarchical methods (SMAC, TPE,
# CloudBandit arms) keep categorical structure instead.  Both encoders are
# offered so the paper's adaptations are reproduced faithfully.
# ---------------------------------------------------------------------------
def attr_encode_config(provider: str, config: dict):
    import numpy as np
    vcpus, mem, price, _speed = node_attrs(provider, config)
    n = config["nodes"]
    return np.array([n / 5.0, vcpus / 4.0, mem / 32.0, price / 0.3,
                     n * vcpus / 20.0], dtype=np.float64)


def attr_encode_point(point):
    import numpy as np
    provider, config = point
    idx = {AWS: 0.0, AZURE: 0.5, GCP: 1.0}[provider]
    return np.concatenate([[idx], attr_encode_config(provider, config)])
