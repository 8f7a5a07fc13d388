"""MeshGraphNet [arXiv:2010.03409; unverified]: 15 layers, d_hidden=128,
sum aggregator, 2-layer MLPs with LayerNorm (encode-process-decode). Twin
of ``repro/configs/meshgraphnet.py``."""
from repro_torch.configs.gnn_common import make_gnn_archdef
from repro_torch.models.gnn import GNNConfig

BASE = GNNConfig(name="meshgraphnet", kind="mgn", n_layers=15, d_hidden=128,
                 d_in=16, n_classes=2, mlp_layers=2, d_edge_in=1)

SMOKE = GNNConfig(name="meshgraphnet-smoke", kind="mgn", n_layers=2,
                  d_hidden=16, d_in=8, n_classes=4, mlp_layers=2,
                  d_edge_in=1)


def _flops(cfg, meta):
    n, e, h = meta["n"], meta["arcs"], cfg.d_hidden
    edge = 2.0 * e * (3 * h * h + h * h)
    node = 2.0 * n * (2 * h * h + h * h)
    return edge + node + e * h


ARCH = make_gnn_archdef("meshgraphnet", BASE, SMOKE, _flops)
