"""The paper's figures on the port: twins of the reference's figure
drivers (``benchmarks/{common,motivation,fig11–fig18}.py`` and the figure
half of ``benchmarks/run.py``) over :mod:`repro_torch.core.cgra`.

    python -m repro_torch.figures.run [--quick] [--device cpu]

Simulated cycles come from host NumPy; only the §3.4 profile of Figs. 17
and 18 runs on ``--device`` (``cache_grid_scan`` on the card by default).
"""
