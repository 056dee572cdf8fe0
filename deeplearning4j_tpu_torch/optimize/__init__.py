"""DL4J's solver stack (``optimize/solvers.py``)."""
