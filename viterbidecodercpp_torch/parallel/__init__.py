"""Parallel decoding over ``torch.distributed`` ranks (the port of the JAX
package's ``parallel/``).

  * frame_dp - independent frames split over a ``data`` axis, one error
    sum a call;
  * block_sp - one long stream's time axis split over a ``time`` axis,
    with warm-up and warm-down halos exchanged between neighbouring
    ranks and a halo-mismatch diagnostic;
  * launch - process-group setup (gloo on the CPU and for ranks sharing a
    card, NCCL between cards), hybrid meshes, each rank's block, and the
    spawned-process fleet used by the tests and the dryrun;
  * mesh - ``DeviceMesh`` construction and the two collectives over an
    axis (a sum, a shift to a neighbour).

The data-parallel BER point is ``ber.measure_point(..., group=)``.
"""

# launch is left out: it runs as `python -m ...parallel.launch`, which
# warns when the package imported it first
from . import block_sp, frame_dp, mesh  # noqa: F401
