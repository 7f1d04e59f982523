"""Host-side data code of the port: the word vocabulary and the image
preprocessing the served path needs."""
