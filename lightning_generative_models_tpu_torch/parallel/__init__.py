"""Scale-out: process groups, the device mesh, batch placement and the strategies' layouts
(``mesh.py``), and the collectives they place (``collectives.py``)."""
