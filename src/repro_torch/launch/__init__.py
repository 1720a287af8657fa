"""Launchers (``repro.launch`` counterparts): the train and serve drivers.
The production mesh and the multi-pod dry-run wait for the multi-card
slice (ROADMAP.md, Queue 1 item 4)."""
