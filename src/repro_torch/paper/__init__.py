"""The paper's experiments on the port — the counterparts of the reference's
``benchmarks/{table1_moa_counts,fig4_serialization,fig5_loa,
moa_strategies}.py``. Each module's ``run(verbose, device)`` returns
``{"us_per_call", "derived"}`` with the reference's ``derived`` keys (and a
few of the port's own, such as the measured times and the route each
strategy took). ``python -m repro_torch.launch.paper_repro`` runs them all.
"""
