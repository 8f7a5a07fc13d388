"""PNA [arXiv:2004.05718; paper]: 4 layers, d_hidden=75, aggregators
mean/max/min/std, scalers identity/amplification/attenuation. Twin of
``repro/configs/pna.py``."""
from repro_torch.configs.gnn_common import make_gnn_archdef
from repro_torch.models.gnn import GNNConfig

BASE = GNNConfig(name="pna", kind="pna", n_layers=4, d_hidden=75,
                 d_in=16, n_classes=2,
                 aggregators=("mean", "max", "min", "std"),
                 scalers=("identity", "amplification", "attenuation"))

SMOKE = GNNConfig(name="pna-smoke", kind="pna", n_layers=2, d_hidden=16,
                  d_in=8, n_classes=4,
                  aggregators=("mean", "max", "min", "std"),
                  scalers=("identity", "amplification", "attenuation"))


def _flops(cfg, meta):
    n, e, h = meta["n"], meta["arcs"], cfg.d_hidden
    n_agg = len(cfg.aggregators) * len(cfg.scalers)
    pre = 2.0 * e * 2 * h * h
    post = 2.0 * n * (n_agg * h + h) * h
    return pre + post + 4.0 * e * h


ARCH = make_gnn_archdef("pna", BASE, SMOKE, _flops)
