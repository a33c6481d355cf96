"""Model code of the port: the LM transformer's serving path (GQA, dense FFN)."""
