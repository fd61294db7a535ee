"""Shard: the (mesh shape, policy) context of the reference's model code.

The reference's models call semantic hooks on a ``Shard`` and never touch
``jax.sharding`` themselves; each hook constrains its tensor to a
``PartitionSpec`` on the mesh.  The port keeps the hooks as descriptions:
each returns the placement the reference would apply, a tuple with one
entry per tensor dim (``None``, an axis name or a tuple of them), given
the policy and a mesh shape (an ordered ``{axis: size}`` mapping,
``launch.mesh``).

* ``activation(x)``  -- a (b, s, d) residual-stream tensor
* ``full_seq(x)``    -- the seq dim gathered (entering attention)
* ``mm_boundary(x)`` / ``mm_input(x)`` -- the weight-matmul boundaries
  under sequence parallelism (``mm_boundary`` gives the forward's and the
  cotangent's placements as a pair)
* ``heads(x)``       -- (b, s, H, hd) q / k / v
* ``cache(x)`` / ``cache_long(x)`` -- a (b, S_max, kv, hd) KV cache
* ``logits(x)``      -- (b, s, vocab)
* ``moe_buffer(x)`` / ``moe_tokens(x)`` -- the expert buffers and tokens
* ``ssm_state(x)``   -- a (b, h, n, p) SSM state

Where the reference applies no constraint, the hook is the identity and
returns ``x``, as the reference's does: with ``mesh_shape=None`` (one
card) every hook, and with a mesh ``mm_boundary`` / ``mm_input`` when the
policy's fix is off and ``heads`` at a head count the model axis does not
divide.  A hook reads only ``x.shape`` (``heads``), so ``x`` may be a
tensor on any device, a meta tensor or anything with a ``shape``.  The
port's models do not call these hooks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..configs.base import ShardingPolicy

__all__ = ["Shard"]


@dataclasses.dataclass(frozen=True)
class Shard:
    mesh_shape: Optional[dict]
    policy: ShardingPolicy

    @staticmethod
    def local(policy: Optional[ShardingPolicy] = None) -> "Shard":
        return Shard(mesh_shape=None, policy=policy or ShardingPolicy())

    def _c(self, x, spec: tuple):
        """The placement of ``x``: ``spec``, or ``x`` itself without a
        mesh."""
        if self.mesh_shape is None:
            return x
        return spec

    def n_data_shards(self) -> int:
        """Extent of the data-parallel axes (1 on a local mesh)."""
        if self.mesh_shape is None:
            return 1
        n = 1
        for a in self.policy.dp_axes:
            n *= self.mesh_shape[a]
        return n

    @property
    def dp(self):
        return self.policy.dp_axes

    @property
    def m(self):
        return self.policy.model_axis

    def activation(self, x):
        """(b, s, d): batch over dp; seq over model when sequence-parallel."""
        if self.policy.seq_shard:
            return self._c(x, (self.dp, self.m, None))
        return self._c(x, (self.dp, None, None))

    def full_seq(self, x):
        """(b, s, d) gathered over seq (entering attention)."""
        return self._c(x, (self.dp, None, None))

    def mm_boundary(self, x):
        """The weight-matmul output boundary under sequence parallelism:
        (forward, cotangent) placements, seq-placed forward (the partial
        sum can reduce-scatter) and a full-seq cotangent (the weight
        gradient's contraction stays seq-local); ``x`` when the fix is off
        or without a mesh."""
        if not (self.policy.seq_shard and self.policy.sp_weightgrad_fix):
            return x
        if self.mesh_shape is None:
            return x
        return ((self.dp, self.m, None), (self.dp, None, None))

    def mm_input(self, x):
        """The weight-matmul input boundary: seq gathered when the fix is
        on; ``x`` otherwise."""
        if self.policy.seq_shard and self.policy.sp_weightgrad_fix:
            return self._c(x, (self.dp, None, None))
        return x

    def heads(self, x):
        """(b, s, H, hd) q / k / v: heads over model (or head_dim per
        policy); ``x`` for a head count the axis does not divide."""
        if self.mesh_shape is None:
            return x
        if self.policy.attn_mode == "heads":
            if x.shape[2] % self.mesh_shape[self.m]:
                return x  # unshardable head count (small models)
            return self._c(x, (self.dp, None, self.m, None))
        return self._c(x, (self.dp, None, None, self.m))

    def cache(self, x):
        """(b, S_max, kv, hd) KV cache."""
        if self.policy.kv_seq_shard:
            return self._c(x, (self.dp, self.m, None, None))
        if self.policy.shard_kv_heads:
            return self._c(x, (self.dp, None, self.m, None))
        return self._c(x, (self.dp, None, None, None))

    def cache_long(self, x):
        """(b, S_max, kv, hd) cache for batch=1 long context: seq over dp."""
        return self._c(x, (None, self.dp, self.m, None))

    def logits(self, x):
        v = self.m if self.policy.shard_vocab else None
        return self._c(x, (self.dp, None, v))

    def moe_buffer(self, x):
        """(D, E, C, d) dispatched expert buffer: dp shards x experts."""
        return self._c(x, (self.dp, self.m, None, None))

    def moe_tokens(self, x):
        """(D, T_local, d) tokens viewed as dp shards."""
        return self._c(x, (self.dp, None, None))

    def ssm_state(self, x):
        """(b, h, n, p) SSM state: heads over model."""
        return self._c(x, (self.dp, self.m, None, None))
