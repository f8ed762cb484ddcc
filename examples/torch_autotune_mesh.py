"""Beyond-paper application on the PyTorch port: CloudBandit autotunes the
sharding strategy.  The twin of ``examples/autotune_mesh.py``.

Arms = parallelism-strategy families; one pull = one trace of the train
step on fake DTensors under a candidate config; objective = three-term
roofline step time on the H100's constants.  Uses a (4, 2) mesh over the
fake process group (``repro_torch.launch.mesh``) and the reduced
qwen1.5-4b cell (seq 128, batch 8), so it completes in a couple of
minutes on a CPU; the production path is
``python -m repro_torch.tuner.autotune``.

A strategy that DTensor cannot trace on the running torch (ROADMAP,
Queue 3) is a failed pull, named on stderr, and the search goes on over
the rest.

This example doubles as the custom-objective recipe: the reduced cell is
not a registry arch, so it registers its own objective
(``register_objective``) and runs it through the same driver/engine stack
as the builtins — every trace lands as a memoized work unit.

    PYTHONPATH=src python examples/torch_autotune_mesh.py [--budget 11]
"""
import argparse
import dataclasses
import functools
import sys

import torch

from repro_torch.configs import REGISTRY, get_shape
from repro_torch.core.objectives import bind_objective, register_objective
from repro_torch.launch.mesh import make_mesh
from repro_torch.tuner.autotune import autotune_search
from repro_torch.tuner.objective import CompileCostObjective
from repro_torch.tuner.strategies import sharding_domain


def _reduced_cell():
    cfg = REGISTRY["qwen1.5-4b"].reduced()
    shape = dataclasses.replace(get_shape("train_4k"),
                                seq_len=128, global_batch=8)
    return cfg, shape


@functools.lru_cache(maxsize=1)
def _objective() -> CompileCostObjective:
    cfg, shape = _reduced_cell()
    return CompileCostObjective(cfg, shape, make_mesh(4, 2), verbose=True)


def eval_reduced(params: dict, context: dict) -> dict:
    """One trace.  A strategy whose step DTensor cannot place on this
    torch raises in the trace; here that pull is a failed evaluation
    (the engine's structured failure, told to the driver as an
    ``EvalFailure``), printed with the operation DTensor names, and the
    search goes on over the strategies that trace."""
    try:
        t, report = _objective().evaluate(params["provider"],
                                          dict(params["config"]))
    except (NotImplementedError, RuntimeError, AssertionError) as exc:
        # DTensor names a placement it cannot make "Sharding propagation
        # failed ..." or, for a redistribution it has no path for,
        # "redistribute ... not supported" / "Redistribution ... is
        # unsupported"
        reason = " ".join(str(exc).split())
        if not any(w in reason.lower() for w in ("sharding", "redistribut")):
            raise
        print(f"reduced_compile: {params['provider']} does not trace on "
              f"torch {torch.__version__}: {reason[-300:]}",
              file=sys.stderr, flush=True)
        return {"failed": True, "reason": reason}
    return {"value": float(t), "report": report}


register_objective(
    "reduced_compile", eval_reduced,
    domain_factory=lambda params: sharding_domain(*_reduced_cell()),
    tags=("example", "compile"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=11)
    ap.add_argument("--driver", default="cb_rbfopt")
    args = ap.parse_args(argv)
    result = autotune_search(bind_objective("reduced_compile"),
                             budget=args.budget, driver=args.driver)
    print("\nbest strategy:", result["best_provider"])
    print("best config:  ", result["best_config"])
    print(f"roofline step time: {result['best_value']*1e3:.3f} ms "
          f"({result['n_evals']} traces spent)")
    return result


if __name__ == "__main__":
    main()
