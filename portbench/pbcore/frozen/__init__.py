"""The yardstick, kept apart from the program: the card's peaks, the
operations and bytes of each unit of work counted from its shapes, the
serving summary and the request generator.  A change to the program
cannot change these."""
