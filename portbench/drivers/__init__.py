"""The code that runs one kind of traffic mix (`driver` in its file)."""
