"""Meshes for the port: the sharding planner as DTensor placements
(``planner.py``), the mesh collectives (``collectives.py``) and the
activation-placement context (``runtime.py``)."""
