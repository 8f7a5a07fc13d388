"""Launchers of the port: the serving CLI (``serve``) and the page mapper
it drives (``placement.PlacementSession.map_pages``)."""
