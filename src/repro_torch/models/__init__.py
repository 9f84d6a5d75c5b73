"""Model code of the port: the Mamba2 ("ssm" family) serving path."""
