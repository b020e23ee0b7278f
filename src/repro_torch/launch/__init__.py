"""Entry points (port of ``repro/launch``): ``train`` so far; the mesh,
serving, dry-run and elastic launchers follow with the distributed
slice."""
