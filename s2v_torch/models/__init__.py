"""The port's models as plain functions over parameter dicts in torch layouts."""
