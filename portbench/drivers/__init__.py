"""One driver a kind of traffic: it sets a cell up, runs its window and
checks what the timed path produced (see `portbench/run.py`)."""
