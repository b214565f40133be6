"""Activation placements of the LM stack (the JAX package's
``distributed/sharding.py``), as far as the models call them.

The reference constrains activations to logical-axis shardings inside a
mesh context and is the identity outside one.  The port has no mesh
context yet, so both functions are the identity; ``default_rules``,
``spec_for``, ``tree_sharding`` and ``mesh_context`` come with the
sharding slice (DTensor/FSDP placements).
"""
from __future__ import annotations


def replicate(x):
    """Constrain ``x`` to be fully replicated: the identity outside a
    mesh context, which is everywhere in the port so far."""
    return x


def shard_activation(x, kind: str):
    """Constrain an activation of logical layout ``kind`` (``"btd"``,
    ``"bthd"``, ``"ecd"``) to the mesh's rules: the identity outside a
    mesh context."""
    return x
