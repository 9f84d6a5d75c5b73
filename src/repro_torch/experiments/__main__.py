"""``python -m repro_torch.experiments`` == the Table II harness CLI."""
from .table2 import main

raise SystemExit(main())
