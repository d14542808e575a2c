"""The sharded path of the port: mesh, collectives and the ring all-gather.

Counterpart of ``recsys_tpu/parallel/``. The execution model is the JAX
package's, one controller: one process drives every shard. A value sharded
over a mesh axis is a Python list of S tensors, one per position on the axis,
shard i on the axis's device i. The devices of a mesh may repeat, so a 4 x 2
mesh can be laid over one card or over ``"cpu"`` (virtual shards). A
collective is a plain function from lists to lists; autograd differentiates
through it, across devices too.
"""
