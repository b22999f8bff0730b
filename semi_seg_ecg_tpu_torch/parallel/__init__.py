"""Training on several GPUs (counterpart of ``semi_seg_ecg_tpu/parallel/``):
the process group and its collectives (``dist.py``), the ``(data, model)``
layout of the ranks (``mesh.py``) and the model axis's parameter slices
(``sharding_rules.py``)."""
