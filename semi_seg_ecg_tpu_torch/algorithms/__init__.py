"""Algorithm registry (counterpart of
``semi_seg_ecg_tpu/algorithms/__init__.py``): each algorithm is a module
with ``train(config)`` and ``test(config)``. All six are ported: ``base``,
``mean_teacher``, ``fixmatch``, ``cps``, ``reco`` and ``stpp``.
"""

from . import base, cps, fixmatch, mean_teacher, reco, stpp

ALGORITHMS = {
    "base": base,
    "mean_teacher": mean_teacher,
    "fixmatch": fixmatch,
    "cps": cps,
    "reco": reco,
    "stpp": stpp,
}


def get_algorithm(name: str):
    if name not in ALGORITHMS:
        raise ValueError(f"Invalid algorithm: {name}")
    return ALGORITHMS[name]
