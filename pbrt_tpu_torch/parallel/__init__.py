"""Multi-device and multi-process parallelism over torch.distributed (port
of pbrt_tpu/parallel/).

Data parallel throughout: the scene is replicated, pixels or sample
indices are split over a device mesh (mesh.py), tile shards are
concatenated with no communication and spp films and parameter gradients
are summed in mesh order (render.py, train.py). multiprocess.py runs the
same over processes joined by torch.distributed; mp_worker.py is one such
process.
"""

from .mesh import make_mesh, shard_pixels  # noqa: F401
from .train import render_loss_and_grad, training_step  # noqa: F401
