"""Algorithm registry (counterpart of
``semi_seg_ecg_tpu/algorithms/__init__.py``): each algorithm is a module
with ``train(config)`` and ``test(config)``. ``base`` and ``fixmatch`` are
ported; the JAX package's other four raise "not yet ported".
"""

from . import base, fixmatch

ALGORITHMS = {
    "base": base,
    "fixmatch": fixmatch,
}

NOT_YET_PORTED = ("mean_teacher", "cps", "reco", "stpp")


def get_algorithm(name: str):
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not yet ported to the torch package")
    if name not in ALGORITHMS:
        raise ValueError(f"Invalid algorithm: {name}")
    return ALGORITHMS[name]
