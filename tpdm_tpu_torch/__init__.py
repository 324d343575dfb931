"""TPDM in PyTorch for NVIDIA Hopper: the port of ``tpdm_tpu``.

Mirrors ``tpdm_tpu``'s module paths and public names. Imports torch and
numpy, never JAX.
"""
