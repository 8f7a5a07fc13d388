"""Arc-list graphs (numpy) and seeded generators."""
