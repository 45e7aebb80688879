"""The sharded layer of the port (port of ``tpuslam/parallel/``), on
``torch.distributed``.

The JAX package runs one program over a device mesh (``shard_map``);
here each rank is one process holding one shard, and
``jax.lax.pmin``/``psum``/``all_gather`` are ``torch.distributed``
collectives (``collectives.py``).  Two axes:

* points: one registration's target cloud split across the ranks, the
  moving cloud and the transform replicated (``icp.py``, ``nicp.py``,
  ``cpd.py``, the combine in ``nn.py``);
* pairs: a batch of independent pairs split across the ranks, with no
  communication until the results are gathered (``batch.py``).

Start a world with ``launch.run_world`` (one spawned process a rank), or
under ``torchrun`` with ``distributed.initialize()`` and
``mesh.make_mesh()``.  Nothing here is exported from ``tpuslam_torch``;
import the modules, as in the JAX package.
"""
