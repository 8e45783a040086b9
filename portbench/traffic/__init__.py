"""Traffic drivers, one module a kind (``train``, ``prefill``), and the
traffic mixes, one data file each (``<name>.json``, whose ``kind``
names its driver)."""
