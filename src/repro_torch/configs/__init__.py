"""Model configurations the port runs: the two-tower retrieval config and
its shape grid (``two_tower_retrieval``), on ``common.ShapeSpec``."""
