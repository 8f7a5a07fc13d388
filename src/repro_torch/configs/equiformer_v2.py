"""EquiformerV2 [arXiv:2306.12059; unverified]: 12 layers, 128 channels,
l_max=6, m_max=2, 8 heads, SO(2)-eSCN equivariant graph attention. Twin of
``repro/configs/equiformer_v2.py``."""
from repro_torch.configs.gnn_common import make_gnn_archdef
from repro_torch.models.equiformer import EquiformerConfig, lm_indices

BASE = EquiformerConfig(name="equiformer-v2", n_layers=12, channels=128,
                        l_max=6, m_max=2, n_heads=8, d_in=16, n_classes=2)

SMOKE = EquiformerConfig(name="equiformer-v2-smoke", n_layers=2, channels=8,
                         l_max=2, m_max=1, n_heads=2, d_in=8, n_classes=4)


def _chunk(meta):
    # bound live per-edge irrep tensors on huge graphs
    return 262144 if meta["arcs"] > 4_000_000 else 0


def _flops(cfg, meta):
    n, e, c = meta["n"], meta["arcs"], cfg.channels
    rows0, rows_pos, _, _ = lm_indices(cfg.l_max, cfg.m_max)
    m_dim = cfg.m_dim
    # wigner rotation: block-diag matvec per l, in and out, 2 convs' worth
    rot = 2.0 * sum((2 * l + 1) ** 2 for l in range(cfg.l_max + 1)) * 2 * c
    # SO(2) linears: conv1 (2C -> C) + conv2 (C -> C)
    so2 = 0.0
    for cin, cout in ((2 * c, c), (c, c)):
        so2 += 2.0 * (len(rows0) * cin) * (len(rows0) * cout)
        for rp in rows_pos:
            so2 += 2.0 * 2 * (len(rp) * cin) * (len(rp) * cout)
    edge = e * (rot + so2)
    node = 2.0 * n * m_dim * c * (3 * c)       # proj + gated FFN
    return edge + node


ARCH = make_gnn_archdef(
    "equiformer-v2", BASE, SMOKE, _flops, with_pos=True, chunk_rule=_chunk,
    notes=("Flagship irrep-tensor-product regime: eSCN SO(2) trick "
           "(O(L^6)->O(L^3)). Synthetic 3D positions supplied for citation/"
           "product graphs (no coordinates in those datasets) — noted in "
           "DESIGN.md."))
