"""The storage configuration gallery and its round trip (``round_trip.py``)."""
