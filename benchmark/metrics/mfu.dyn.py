"""mfu.dyn: Percent of the H100's float32 peak (67 TFLOP/s) that the
operations the traced steps of the time-conditioned permutohedral NeuS
need take of their wall time at the pace of the run's untraced steps:
every Linear layer's 2*in*out a row (x3 with its backward), the
decoder's input-gradient pass for the nablas (x3 under the eikonal
loss), and the 4D lattice's encodes, their backwards, the nablas and
their backwards (`harness/permuto_work.py`): the whole step's share."""

from harness.permuto_work import mfu as read  # noqa: F401
