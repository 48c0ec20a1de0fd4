"""Plain references that decide `correct`: the served models in float32
(`lm.py`) and the placement problem (`placement.py`).  They import
nothing of the program."""
