"""One driver per kind of traffic: it sets the program up, runs the
measured window and decides `correct`."""
