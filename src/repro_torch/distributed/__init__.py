"""Placement rules (counterpart of ``repro.distributed``): which dim of
each parameter, optimizer, batch and cache leaf goes on which mesh axis
(``sharding``), and the activation layout pins the models call through
``constraints.constrain``."""
