"""Models of the port: the dense MLP block (``mlp``), the two-tower
retrieval model's serving path (``recsys``), the GIN forward on a BSR
adjacency (``gnn``) and the GQA and MoE + MLA transformer
(``transformer``), with
the shared pieces in ``common`` (norms, RoPE, the chunked attention
forward, ``cross_entropy``)."""
