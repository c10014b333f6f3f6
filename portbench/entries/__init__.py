"""Adapters of the port's entry points, one file each, found by the
``entry`` name of a traffic mix.  Each defines ``build``, ``inputs``,
``given``, ``solve``, ``answer``, ``converged``, ``counts``,
``answer_f64``, ``control`` and ``close`` (see ``df_northstar.py``)."""
