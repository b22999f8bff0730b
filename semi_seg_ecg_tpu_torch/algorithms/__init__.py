"""Algorithm registry (counterpart of
``semi_seg_ecg_tpu/algorithms/__init__.py``): each algorithm is a module
with ``train(config)`` and ``test(config)``. ``base``, ``mean_teacher``,
``fixmatch`` and ``cps`` are ported; ``reco`` and ``stpp`` raise "not yet
ported".
"""

from . import base, cps, fixmatch, mean_teacher

ALGORITHMS = {
    "base": base,
    "mean_teacher": mean_teacher,
    "fixmatch": fixmatch,
    "cps": cps,
}

NOT_YET_PORTED = ("reco", "stpp")


def get_algorithm(name: str):
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not yet ported to the torch package")
    if name not in ALGORITHMS:
        raise ValueError(f"Invalid algorithm: {name}")
    return ALGORITHMS[name]
