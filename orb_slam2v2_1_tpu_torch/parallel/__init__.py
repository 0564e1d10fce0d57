"""The multi-session map server: delta encoding, per-client maps and the
cross-session merge (`server.py`), and its TCP transport (`stream.py`)."""
