"""Models of the port: the dense MLP block (``mlp``), the two-tower
retrieval model's serving path (``recsys``) and the GIN forward on a BSR
adjacency (``gnn``), with ``common.cross_entropy``."""
