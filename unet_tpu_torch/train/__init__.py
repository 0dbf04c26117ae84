"""Step factories (the predict steps; the train step joins in a later
slice)."""
