"""The K1 attention layout and tuning studies of ``experiments/attn_*.py``,
ported: one module per study script, under its file name, holding the
counterparts of its call functions on the Hopper kernels K4-K9. Each
module's ``main`` times its variants on a CUDA card (``python -m
tpdm_tpu_torch.experiments.<name>``); the functions run wherever their
tensors are, the plain versions on the CPU."""
