"""AdamW with the reference's arithmetic (``adamw``)."""
