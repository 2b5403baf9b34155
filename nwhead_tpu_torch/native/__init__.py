"""Host-side native code of the port: the HNSW index (``hnsw.py``) and the
libjpeg decode pool (``decode.py``)."""
