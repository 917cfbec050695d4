"""The paper's runners on the port: ``tables`` (one function per paper
table or figure) and ``run`` (the command line, with the scaling and
retention sweeps).  ``python -m repro_torch.bench.run --help``."""
