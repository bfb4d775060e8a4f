"""Host-side data: synthetic matching workloads and the keypoint-graph
transforms (NumPy / SciPy)."""

from dgmc_tpu_torch.data.transforms import (Cartesian, Compose, Constant,
                                            Delaunay, Distance, FaceToEdge,
                                            KNNGraph)
from dgmc_tpu_torch.data.synthetic import (RandomGraphPairs, SyntheticKG,
                                           synthetic_kg_alignment)

__all__ = ['Cartesian', 'Compose', 'Constant', 'Delaunay', 'Distance',
           'FaceToEdge', 'KNNGraph', 'RandomGraphPairs', 'SyntheticKG',
           'synthetic_kg_alignment']
