"""The port's copies of the reference's four examples (``examples/``), one
module each, runnable as ``python -m repro_torch.examples.<name>``:

* :mod:`.quickstart` — the paper's Table-1 grid under four strategies;
* :mod:`.elastic_failover` — site outages in the simulation, then a
  checkpoint restored from the replica HRS picks;
* :mod:`.serve_grid` — grid-routed greedy serving of granite-3-8b;
* :mod:`.train_small_grid` — a ~100M gemma3-family model trained on
  grid-placed shards under the checkpoint/restart supervisor.

Each prints what its reference prints and returns the numbers as a dict.
Each runs on the CUDA card unless given ``--device cpu`` and raises
without one.
"""
