"""The plain reference that decides ``correct`` (``plain.py``) and the readings its limits are set from (``readings.py``)."""
