"""Immutable dataclass pytrees: the base class of every solver, env, replay and
learner state.

A subclass of ``PyTreeNode`` becomes a frozen dataclass registered with
``jax.tree_util.register_dataclass``; every field is a data leaf (no field is
static), so instances pass through ``jit``, ``vmap``, ``scan`` and
``shard_map`` as pytrees.  ``.replace(**kw)`` returns a copy with fields
changed.  Instances pickle by class path and field values.
"""

from __future__ import annotations

import dataclasses

import jax


class PyTreeNode:
    """Base class: subclasses are frozen dataclasses registered as pytrees.

        class State(PyTreeNode):
            u: jax.Array
            t: jax.Array

        s2 = s.replace(t=s.t + 1)
    """

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        names = [f.name for f in dataclasses.fields(cls)]
        jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])

    def replace(self, **overrides):
        return dataclasses.replace(self, **overrides)
