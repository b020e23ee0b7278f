"""Machine profile of the card the port runs on (``machine.py``)."""
