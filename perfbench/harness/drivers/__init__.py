"""The drivers, one a traffic kind: ``<kind>.py`` runs a mix whose
``kind`` is its name (``run(...)``) and reads its correctness numbers
and its control for ``control.py`` (``readings(...)``)."""
