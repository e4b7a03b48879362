from dune_eigensolver_tpu_torch.cli import main

raise SystemExit(main())
