"""PyTorch / CUDA port of the ``repro`` package, for an NVIDIA H100.

Module names mirror ``repro``: ``repro_torch.models.zoo`` is the port of
``repro.models.zoo``, and so on. The port imports torch and numpy, never jax
and never ``repro``; the consensus modules (``core/``, ``data/pipeline.py``,
``runtime/controlplane.py``) are verbatim copies held to the originals by
``tests/test_torch_controlplane.py``.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise when
CUDA is asked for and absent: nothing falls back to the CPU.
"""
