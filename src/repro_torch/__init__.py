"""PyTorch/CUDA port of the CamJ design-space exploration engine.

``repro_torch`` grows beside the JAX reference package ``repro`` and is
held against it by the ``tests/test_torch_*.py`` parity tests.  It
imports ``torch`` and numpy only: the jax-free model layer (component
models, lowering, algorithm registry) is kept as verbatim copies under
``repro_torch.core``, and nothing of ``repro`` or ``jax`` is ever
imported.

The front door is :func:`repro_torch.explore.explore`; it runs on the
CUDA device unless the caller passes ``device="cpu"``.
"""
