"""The LM stack's models (torch counterpart of ``src/repro/models/``):
``config`` (a verbatim copy), ``common``, ``moe``, ``ssm``, ``model``
(init / forward / prefill / decode for every family) and ``convert``
(numpy trees <-> the port's tensors)."""
