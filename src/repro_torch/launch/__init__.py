"""Launchers (``repro.launch`` counterparts): the train and serve command
lines and the device meshes over a world's ranks.  The multi-pod dry-run
is not ported (ROADMAP.md, Queue 1)."""
