"""Models of the port: the dense MLP block (``mlp``) and the two-tower
retrieval model's serving path (``recsys``)."""
