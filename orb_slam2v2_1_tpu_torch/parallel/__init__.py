"""Distribution: the multi-session map server, its delta encoding, per-client
maps and cross-session merge (`server.py`) and TCP transport (`stream.py`);
the one-axis device mesh with its all-reduce (`mesh.py`) and the bundle
adjustment sharded over it (`dist_ba.py`)."""
