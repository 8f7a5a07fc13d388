"""GIN [arXiv:1810.00826; paper]: 5 layers, d_hidden=64, sum aggregator,
learnable eps. Twin of ``repro/configs/gin_tu.py``."""
from repro_torch.configs.gnn_common import make_gnn_archdef
from repro_torch.models.gnn import GNNConfig

BASE = GNNConfig(name="gin-tu", kind="gin", n_layers=5, d_hidden=64,
                 d_in=16, n_classes=2, eps_learnable=True)

SMOKE = GNNConfig(name="gin-tu-smoke", kind="gin", n_layers=2, d_hidden=16,
                  d_in=8, n_classes=4)


def _flops(cfg, meta):
    n, e, h = meta["n"], meta["arcs"], cfg.d_hidden
    return 2.0 * (n * 2 * h * h) + e * h      # MLP (h->h->h) + sum agg


ARCH = make_gnn_archdef("gin-tu", BASE, SMOKE, _flops)
