"""The traffic kinds, one module each, found by the `kind` of a traffic
file (`lib/drive.kind`): `Drive`, the generator of a cell's inputs and
units; `Check`, what its check keeps and compares; `FAULTS`, the faults
planted under it (`lib/faults.py`)."""
