"""Training: the loss (``loss``), the step factories (``step``) and the
host loop (``trainer``)."""
