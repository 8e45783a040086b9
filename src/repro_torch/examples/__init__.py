"""The port's example scripts, each run as ``python -m
repro_torch.examples.<name>`` (on the CUDA device unless ``--device cpu``
is given):

* ``quickstart`` — the paper's Fig. 5 system, declared, checked and
  estimated, and its pipeline run on K5 ``binning`` and K6
  ``stencil_conv``;
* ``explore_design_space`` — the Sec. 6 studies, ``explore()`` over the
  hook axes, the algorithm registry, the streaming mega-sweep (K1;
  ``MEGA_SWEEP=1`` densifies it to 4.35e7 points), kill-and-resume and
  ``workers=2`` campaigns, the two-tenant service and the dry-run
  bridge;
* ``train_lm`` — a reduced architecture trained a few hundred steps by
  ``repro_torch.train.TrainLoop``.
"""
