"""The port's resilience plane: so far only the admission names the
generation batcher and the usage meter need (`admission.py`)."""
