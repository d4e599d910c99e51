"""The paper's evaluation on the port (counterparts of the repo-root
``benchmarks/`` files of the same names): the figure and table suite
(:mod:`~repro_torch.benchmarks.paper_tables`), the DES engine bench
(:mod:`~repro_torch.benchmarks.coordination_bench`), their CLI
(``python -m repro_torch.benchmarks.run``) and the load-balancing gate
matrix (``python -m repro_torch.benchmarks.balance_bench``).  Routing and
hop plans run on ``device`` (None = the CUDA card), the DES on the host.
"""
