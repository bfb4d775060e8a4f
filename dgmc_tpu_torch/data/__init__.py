"""Host-side data: synthetic matching workloads and the keypoint-graph
transforms (NumPy / SciPy)."""

from dgmc_tpu_torch.data.transforms import (Cartesian, Compose, Constant,
                                            Delaunay, Distance, FaceToEdge,
                                            KNNGraph)

__all__ = ['Cartesian', 'Compose', 'Constant', 'Delaunay', 'Distance',
           'FaceToEdge', 'KNNGraph']
