"""The browser chat front of the examples (``serve.py``)."""
