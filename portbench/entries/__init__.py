"""The timed entries into the port, one module each, found by the name a
traffic file gives.  Each defines ``Entry(cell, seed, device, spans)``:
its constructor is the set-up and warm-up; ``step()`` runs one unit of the
window's work and returns (units completed, a record for the reference's
``count``); ``release()`` frees the program's state; ``check()`` returns
the numbers that ``correct`` compares with the cell's limits; ``failed``
counts units that came back wrong in kind (missing or misshapen)."""
