"""Example apps on the port (counterparts of ``examples/``):
``llama_generate``, the Llama ``/generate`` microservice."""
