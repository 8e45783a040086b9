"""CamJ core of the PyTorch port: model layer, lowering and sweep engine.

The model layer (``constants`` ... ``algorithms``, ``usecases``) is a
verbatim copy of the reference's jax-free modules; ``axes``, ``grid``,
``plan_bank``, ``batch`` and ``shard_sweep`` are the torch rewrites of
the reference's jax modules on the fused streaming sweep path.
"""
