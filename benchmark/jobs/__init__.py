"""Jobs: each builds the system under test for one kind of traffic, runs
its entry in the window and reads what it produced against the reference."""
