"""One module per model family: it builds the port's system for a
configuration file, makes that configuration's inputs from the seed, and
compares what the timed path produced with the plain reference."""
