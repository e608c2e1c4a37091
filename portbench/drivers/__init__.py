"""One driver per entry of the program that a cell's window drives,
named by the traffic file's `driver` key."""
