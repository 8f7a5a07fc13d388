"""Launchers of the port: the serving CLI (``serve``), the training CLI
(``train``) and the page mapper the server drives
(``placement.PlacementSession.map_pages``)."""
