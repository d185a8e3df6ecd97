from portbench.run import main

raise SystemExit(main())
