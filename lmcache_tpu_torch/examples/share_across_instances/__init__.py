"""Two serving instances sharing one cache server (``share.py``)."""
