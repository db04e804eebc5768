"""Observability planes of the port (those of dingo_tpu/obs): QoS admission,
pressure and the degrade ladder (``pressure.py``), the kernel
launch-and-shape sentinel (``sentinel.py``), state integrity
(``integrity.py``), quality and the SLO tuner (``quality.py``,
``tuner.py``), workload heat (``heat.py``), the dispatch cost model
(``cost.py``), the control-plane event ledger (``events.py``), the HBM
ledger (``hbm.py``) and the flight recorder (``flight.py``). Each module
is imported by its own path; this package imports none of them."""
