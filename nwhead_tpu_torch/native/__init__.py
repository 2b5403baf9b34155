"""Host-side native code of the port: the HNSW index (``hnsw.py``)."""
