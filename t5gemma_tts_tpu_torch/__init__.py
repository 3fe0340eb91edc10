"""PyTorch/CUDA port of T5Gemma-TTS for NVIDIA Hopper.

Mirrors the module paths and function names of the JAX package
``t5gemma_tts_tpu`` (the reference), imports nothing of it and never imports
``jax``. Parameters are nested dicts of tensors with the JAX tree's key names
and its stacked ``[L, ...]`` layer axis. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; the TPU's Pallas kernels on the ported
path are hand-written CUDA kernels under ``csrc/``.
"""
