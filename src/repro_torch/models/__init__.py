"""Model building blocks of the port (``layers``) and the decoder-only LM
built from them (``transformer``)."""
