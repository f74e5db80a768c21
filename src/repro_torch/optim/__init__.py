"""AdamW with the reference's schedule and clipping (``adamw``), and int8
error-feedback gradient compression (``compress``)."""
