"""The repo's demos on the port (counterparts of the repo-root
``examples/`` files of the same names), each run as
``python -m repro_torch.examples.<name> [--device cpu]``; ``--device``
defaults to the CUDA card.  Each module's ``run`` prints the reference
demo's lines and returns them (the serving and training demos with their
tokens and per-step numbers too)."""
