from ccx_torch.main import main

raise SystemExit(main())
