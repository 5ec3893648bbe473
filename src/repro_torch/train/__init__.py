"""Training state of the port (the LLM path of ``repro.train``)."""
