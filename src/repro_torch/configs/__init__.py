"""Model configurations the port runs: the two-tower retrieval config and
its shape grid (``two_tower_retrieval``) and GIN-TU over the GNN shape grid
(``gin_tu`` on ``gnn_common``), on ``common.ShapeSpec`` / ``ArchDef``."""
