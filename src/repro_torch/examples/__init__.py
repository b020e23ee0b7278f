"""The examples (port of the repo's ``examples/``), one module each, run
as ``python -m repro_torch.examples.<name>``:

- ``serve_paged``: continuous batching through the paged-DBS engine, more
  requests than slots;
- ``fork_sessions``: session forks as DBS clones with copy-on-write;
- ``quickstart``: train, checkpoint to two replicas, restart, serve;
- ``train_lm``: a 67.7M-parameter LM on the reference's training plan
  (bf16 compute over fp32 params).

Each has ``main(argv=None, *, params=None)``: it runs on the card unless
``--device cpu`` is given (and raises when there is none), prints the
reference example's lines (timing lines name the device), and returns a
dict whose ``"lines"`` are what it printed, beside what a caller checks.
``params`` takes weights in place of the seeded draw: a tree of numpy
arrays as the reference's ``init_params`` gives them, crossed with
``core/convert.py params_from_numpy``.
"""
