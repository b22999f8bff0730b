"""Data-parallel training on several GPUs (counterpart of
``semi_seg_ecg_tpu/parallel/``): the process group and its collectives
(``dist.py``) and the data-parallel layout (``mesh.py``)."""
